"""Time-sharded bar products and order statistics over a process group.

Counterpart of ``finmlkit_tpu/parallel/sharded.py``. The trade axis is cut into
contiguous spans, one a rank (no padding); bar close indices (small, on every
rank) define bars that may straddle a span's edges. Each rank owns the bars
whose closing trade is in its span (rank 0 also those that close before trade
0) and runs the port's float path, ``bar/aggregate.py`` (kernels S and C), over
its trades: a bar wholly in its span comes out final. Only a bar that
straddles an edge is combined: every rank hands on the record of its piece of
the bar its span ends inside (sums in float64, extrema, the first and last
price, and the in-bar running imbalance extrema with the piece's totals, so
that a piece's extrema can be offset by the bar's prefix on the ranks before
it), and the owner merges the pieces in rank order. Order statistics (the
median, the 95th percentile) of owned bars come from a local sort, and those
of straddling bars from a radix select over the 32 order-preserving bits of
the float32 amounts (each round one all-reduce of the candidates' counts), so
that no trade moves. The owned bars' results are then gathered to every rank.

Each rank's spread of its first trade is taken against the trade before its
span (a halo of one trade; the stream's last for rank 0, as ``torch.roll``
takes it), so the spreads are the single-device path's. Integers, prices,
extrema of exact values and order statistics equal the single-device path's
bit for bit; float64 sums of a straddling bar add its pieces' sums, within
``testing.hold_float_path``'s bounds.

Functions take a :class:`TradeShard` (:func:`shard_trades`) and the global close
indices, and return per-bar tensors on the mesh's device, the same on every
rank.
"""
from dataclasses import dataclass
from fractions import Fraction

import numpy as np
import torch

from ..bar.aggregate import (comp_bar_directional_features, comp_bar_ohlcv,
                             comp_bar_trade_size_features, trade_size_final)
from ..ops.prefix_scan import fast_cumsum_cols
from ..ops.segment import (_from_sortable_bits, _sortable_bits, bar_ids_from_close_indices,
                           sorted_segments)
from .mesh import TimeMesh, all_gather, all_reduce

__all__ = ["TradeShard", "shard_trades", "sharded_bar_products", "sharded_segment_kth",
           "sharded_median_trade_size", "sharded_trade_size_features"]

_F64 = torch.float64


@dataclass(frozen=True)
class TradeShard:
    """Rank ``rank``'s contiguous span of a trade stream: ``columns`` (name
    -> tensor on the mesh's device) hold trades ``lo .. hi-1`` of ``n``;
    ``spans`` are every rank's ``(lo, hi)``."""
    columns: dict
    rank: int
    n: int
    spans: tuple

    def __getitem__(self, name):
        return self.columns[name]

    @property
    def lo(self) -> int:
        return self.spans[self.rank][0]

    @property
    def hi(self) -> int:
        return self.spans[self.rank][1]


def _tensor(x, device):
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device)


def shard_trades(arrays: dict, mesh: TimeMesh, *, offset: int | None = None) -> TradeShard:
    """This rank's span of trade columns, on the mesh's device.

    With ``offset`` None the columns are the whole stream (host numpy arrays
    or tensors) and rank r takes the even contiguous span ``mesh.span(n)``;
    with ``offset`` they are this rank's own trades, the first at global
    index ``offset``, and the spans come from one all-gather of every rank's
    offset and length (they must tile ``[0, n)`` in rank order). Spans need
    not be equal, and nothing is padded (the JAX package pads to a multiple
    of the mesh)."""
    lengths = {len(v) for v in arrays.values()}
    if len(lengths) != 1:
        raise ValueError(f"trade columns of different lengths: {sorted(lengths)}")
    length = lengths.pop()
    if offset is None:
        spans = tuple(mesh.span(length, r) for r in range(mesh.size))
    else:
        got = all_gather(mesh, torch.tensor([int(offset), length], dtype=torch.int64))
        spans = tuple((int(o), int(o) + int(m)) for o, m in got.tolist())
        if spans[0][0] != 0 or any(spans[r][0] != spans[r - 1][1]
                                   for r in range(1, mesh.size)):
            raise ValueError(f"the ranks' spans {spans} do not tile the stream in rank order")
    lo, hi = spans[mesh.rank]
    cols = {k: _tensor(v[lo:hi] if offset is None else v, mesh.device)
            for k, v in arrays.items()}
    return TradeShard(cols, mesh.rank, spans[-1][1], spans)


def gather_ragged(mesh: TimeMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's 1-D ``t`` (any lengths), concatenated in rank order."""
    counts = all_gather(mesh, torch.tensor([t.numel()], dtype=torch.int64,
                                           device=t.device)).flatten().tolist()
    m = max(counts)
    if m == 0:
        return t[:0]
    pad = torch.zeros(m, dtype=t.dtype, device=t.device)
    pad[:t.numel()] = t
    got = all_gather(mesh, pad)
    return torch.cat([got[r, :c] for r, c in enumerate(counts)])


def values_at(mesh: TimeMesh, shard: TradeShard, col: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
    """``col`` at global trade indices ``idx`` (a negative index wraps), each
    from the rank that holds it: one all-reduce of ``idx``'s size."""
    i = torch.where(idx < 0, idx + shard.n, idx)
    m = col.shape[0]
    mine = (i >= shard.lo) & (i < shard.lo + m)
    v = torch.zeros(i.shape, dtype=col.dtype, device=col.device)
    if m:
        v = torch.where(mine, col[(i - shard.lo).clamp(0, m - 1)], v)
    return all_reduce(mesh, v, "sum")


# --- the bars of a rank -----------------------------------------------------


class _Bars:
    """The bars of this rank for the global close indices ``ci`` (a host
    int64 array): owned bars ``[b0, b1)``, their close indices in this rank's
    coordinates ``ci_own`` (trade 0 at index 0; the first owned bar's open
    clamped to -1), every straddling bar, and the bar this rank's span ends
    inside where a later rank owns it."""

    def __init__(self, mesh: TimeMesh, shard: TradeShard, ci):
        ci = np.asarray(ci, np.int64)
        self.ci, self.nb = ci, len(ci) - 1
        los = [lo for lo, _ in shard.spans]
        bounds = [0] + [int(np.searchsorted(ci[1:], lo)) for lo in los[1:]] + [self.nb]
        self.bounds = bounds
        self.b0, self.b1 = bounds[mesh.rank], bounds[mesh.rank + 1]
        lo, hi = shard.spans[mesh.rank]
        self.lo, self.m = lo, hi - lo
        self.ci_own = np.maximum(ci[self.b0:self.b1 + 1] - lo, -1)
        # a bar straddles where its trades lie on two ranks or more
        owner = np.searchsorted(np.asarray(los[1:]), np.maximum(ci[1:], 0), side="right")
        first = np.searchsorted(np.asarray(los[1:]), np.minimum(ci[:-1] + 1, ci[1:]),
                                side="right")
        self.straddling = np.flatnonzero((ci[1:] > ci[:-1]) & (first < owner))
        # the piece this rank hands on: the bar holding its last trade, owned later
        self.upper = -1
        if self.m and self.b1 < self.nb and ci[self.b1] < hi - 1:
            self.upper = self.b1

    def piece(self, b: int):
        """Bar b's trades in this rank's span: local ``(a, e]``, or None."""
        a = max(int(self.ci[b]) - self.lo, -1)
        e = min(int(self.ci[b + 1]) - self.lo, self.m - 1)
        return (a, e) if e > a else None


def _extended(shard: TradeShard, mesh: TimeMesh, names):
    """The columns with the trade before the span prepended (the stream's
    last before trade 0): ``torch.roll``'s neighbour of the span's first
    trade. One all-gather of every rank's last trade."""
    lasts = []
    for name in names:
        col = shard[name]
        v = col[-1:].to(_F64) if col.shape[0] else torch.zeros(1, dtype=_F64,
                                                                 device=col.device)
        lasts.append(v)
    has = torch.tensor([float(shard[names[0]].shape[0] > 0)], dtype=_F64,
                       device=mesh.device)
    got = all_gather(mesh, torch.cat(lasts + [has]))      # (size, len(names) + 1)
    prev = [r for r in range(mesh.size) if got[r, -1] > 0]
    # the last non-empty rank before this one, the stream's last for rank 0
    before = [r for r in prev if r < mesh.rank]
    src = before[-1] if before else prev[-1]
    return {name: torch.cat([got[src, j].to(shard[name].dtype).reshape(1), shard[name]])
            for j, name in enumerate(names)}


def _piece_record(ext, a: int, e: int, counts_single: bool = False):
    """The float64 record of the trades ``(a, e]`` (local coordinates) of a
    straddling bar: count, first and last price, high, low, volume, dollars,
    buy and sell ticks, volumes and dollars, the spread sum and max, and for
    the signed ticks, volumes and dollars the piece's total and the largest
    and smallest running sum from its start over trades with a side."""
    p, amt, s = (ext[k][a + 2:e + 2] for k in ("price", "amount", "side"))
    pp, ps = ext["price"][a + 1:e + 1], ext["side"][a + 1:e + 1]   # the trades before
    a64, s64 = amt.to(_F64), s.to(torch.int64)
    d = p * a64
    buy, sell = (s64 == 1).to(_F64), (s64 == -1).to(_F64)
    spread = torch.where(s64 != ps.to(torch.int64), torch.abs(p - pp), 0.0)
    sig = s64.to(_F64)
    sums = fast_cumsum_cols(torch.stack([a64, d, buy, sell, buy * a64, sell * a64, buy * d,
                                         sell * d, spread]))[:, -1]
    run = fast_cumsum_cols(torch.stack([sig, sig * a64, sig * d]))
    inf = torch.tensor(float("inf"), dtype=_F64, device=p.device)
    on = s64 != 0
    mx = torch.where(on, run, -inf).amax(dim=1)
    mn = torch.where(on, run, inf).amin(dim=1)
    head = torch.stack([torch.tensor(float(e - a), dtype=_F64, device=p.device), p[0], p[-1],
                        p.max(), p.min()])
    return torch.cat([head, sums, spread.max().reshape(1), run[:, -1], mx, mn])


_REC = 5 + 9 + 1 + 3 + 3 + 3     # fields of a piece record


def _merge_records(recs):
    """One straddling bar's values from its pieces' records in rank order."""
    total = sum(r[5:14] for r in recs)
    off = torch.zeros(3, dtype=_F64, device=recs[0].device)
    mx = torch.full((3,), -float("inf"), dtype=_F64, device=off.device)
    mn = torch.full((3,), float("inf"), dtype=_F64, device=off.device)
    for r in recs:
        mx = torch.maximum(mx, r[18:21] + off)
        mn = torch.minimum(mn, r[21:24] + off)
        off = off + r[15:18]
    return dict(count=sum(float(r[0]) for r in recs), open=recs[0][1], close=recs[-1][2],
                high=max(float(r[3]) for r in recs), low=min(float(r[4]) for r in recs),
                sums=total, spread_max=max(float(r[14]) for r in recs), mx=mx, mn=mn)


def _straddler_records(mesh, shard, bars, ext):
    """Every rank's record of the piece it hands on (the bar its span ends
    inside, -1 where none), gathered: ``(bar ids, (size, fields))``."""
    rec = torch.zeros(_REC + 1, dtype=_F64, device=mesh.device)
    rec[0] = float(bars.upper)
    if bars.upper >= 0:
        a, e = bars.piece(bars.upper)
        rec[1:] = _piece_record(ext, a, e)
    got = all_gather(mesh, rec)
    return got[:, 0].to(torch.int64).tolist(), got[:, 1:]


def _own_straddler(bars):
    """The first owned bar where it straddles (its open before the span)."""
    if bars.b1 > bars.b0 and bars.b0 in set(bars.straddling.tolist()):
        return bars.b0
    return -1


def _records_of(bar, ids, recs, mesh):
    return [recs[r] for r in range(mesh.rank) if ids[r] == bar]


# --- order statistics ---------------------------------------------------------


def _radix_select(mesh, shard, bars, vals32, ks):
    """The k-th smallest (0-based, ``ks`` int64 ``(q, len(bars.straddling))``)
    float32 value of each straddling bar over every rank's piece: 32 rounds,
    most significant bit first, each counting the local values below a
    candidate and summing the counts over the ranks; the largest candidate
    whose count is at most k is the k-th value. ``(q, n_straddling)``."""
    S = bars.straddling
    dev = mesh.device
    keys = [torch.zeros(0, dtype=torch.int64, device=dev)]
    for j, b in enumerate(S.tolist()):
        pc = bars.piece(b)
        if pc is not None:
            keys.append((j << 32) | _sortable_bits(vals32[pc[0] + 1:pc[1] + 1]))
    keys = torch.sort(torch.cat(keys)).values
    ks = torch.as_tensor(ks, dtype=torch.int64, device=dev)
    jj = torch.arange(len(S), dtype=torch.int64, device=dev) << 32
    base = torch.searchsorted(keys, jj)[None, :]
    v = torch.zeros(ks.shape, dtype=torch.int64, device=dev)
    for bit in range(31, -1, -1):
        cand = v | (1 << bit)
        below = torch.searchsorted(keys, (jj[None, :] | cand).reshape(-1)).reshape(ks.shape)
        tot = all_reduce(mesh, below - base, "sum")
        v = torch.where(tot <= ks, cand, v)
    return _from_sortable_bits(v)


def _owned_kth(bars, vals32, ks_own, dev):
    """The k-th value of each owned bar from a local sort (the first owned
    bar's is that of its local piece)."""
    ci = torch.as_tensor(bars.ci_own, device=dev)
    nb = ci.shape[0] - 1
    bar_id, valid = bar_ids_from_close_indices(ci, vals32.shape[0])
    srt = sorted_segments(vals32, bar_id, valid, nb)
    pos = (ci[:-1] - ci[0])[None, :] + torch.as_tensor(ks_own, device=dev)
    if srt.numel() == 0:
        return torch.zeros(pos.shape, dtype=torch.float32, device=dev)
    return srt[pos.clamp(0, srt.shape[0] - 1)]


def _gather_owned(mesh, bars, rows: torch.Tensor) -> torch.Tensor:
    """Every rank's owned bars' ``(k, owned)`` rows, as ``(k, n_bars)``."""
    k = rows.shape[0]
    got = gather_ragged(mesh, rows.t().contiguous().reshape(-1))
    return got.reshape(bars.nb, k).t()


def _kth(mesh, shard, bars, vals32, ks):
    """``ks`` (host int64 ``(q, n_bars)``) -> ``(q, n_bars)`` float32 on every
    rank: owned bars locally, straddling bars by the radix select."""
    dev = mesh.device
    own = _owned_kth(bars, vals32, ks[:, bars.b0:bars.b1], dev)
    out = _gather_owned(mesh, bars, own.to(_F64)).to(torch.float32)
    if len(bars.straddling):
        idx = torch.as_tensor(bars.straddling, device=dev)
        out[:, idx] = _radix_select(mesh, shard, bars, vals32, ks[:, bars.straddling])
    return out


def sharded_segment_kth(values, ci, ks, mesh: TimeMesh, *, offset: int | None = None):
    """The k-th smallest float32 value of every bar across the ranks
    (``ks``: ``(q, n_bars)`` 0-based ranks within each bar): ``(q, n_bars)``
    float32 on every rank, garbage for empty bars (callers mask). ``values``
    are the whole stream's, or this rank's from global index ``offset``
    (:func:`shard_trades`). Owned bars are selected by a local sort; bars
    that straddle ranks by 32 rounds of a radix select, as the JAX function
    selects every bar, each round one all-reduce of ``(q, straddling)``
    counts."""
    shard = shard_trades({"v": values}, mesh, offset=offset)
    bars = _Bars(mesh, shard, ci)
    return _kth(mesh, shard, bars, shard["v"].to(torch.float32),
                np.asarray(ks, np.int64).reshape(-1, bars.nb))


def _median_ks(counts):
    return np.stack([np.maximum(counts - 1, 0) >> 1, np.maximum(counts, 1) >> 1])


def sharded_median_trade_size(trades: TradeShard, ci, mesh: TimeMesh) -> torch.Tensor:
    """Every bar's median trade size (float64, the mean of the two middle
    float32 amounts, 0 on an empty bar), as ``comp_bar_ohlcv`` gives it."""
    bars = _Bars(mesh, trades, ci)
    counts = np.diff(bars.ci)
    pair = _kth(mesh, trades, bars, trades["amount"].to(torch.float32), _median_ks(counts))
    med = (pair[0].to(_F64) + pair[1].to(_F64)) * 0.5
    return torch.where(torch.as_tensor(counts == 0, device=med.device), 0.0, med)


# --- bar products -------------------------------------------------------------

# the keys and dtypes of comp_bar_ohlcv and comp_bar_directional_features
_I64, _F32 = torch.int64, torch.float32
_PRODUCTS = {"open": _F64, "high": _F64, "low": _F64, "close": _F64, "volume": _F32,
             "vwap": _F64, "trades": _I64, "median_trade_size": _F64,
             "ticks_buy": _I64, "ticks_sell": _I64, "volume_buy": _F32, "volume_sell": _F32,
             "dollars_buy": _F32, "dollars_sell": _F32, "mean_spread": _F32,
             "max_spread": _F32, "cum_ticks_min": _I64, "cum_ticks_max": _I64,
             "cum_volume_min": _F32, "cum_volume_max": _F32, "cum_dollars_min": _F32,
             "cum_dollars_max": _F32}


def _straddler_products(mesh, trades, bars, ext, merged_median):
    """The products of this rank's own straddling bar from its pieces."""
    ids, recs = _straddler_records(mesh, trades, bars, ext)
    b = _own_straddler(bars)
    if b < 0:
        return None
    a, e = bars.piece(b)
    pieces = _records_of(b, ids, recs, mesh) + [_piece_record(ext, a, e)]
    g = _merge_records(pieces)
    f32 = torch.float32
    s = g["sums"]
    vol = s[0]
    vwap = s[1] / vol if float(vol) > 0 else torch.zeros((), dtype=_F64, device=vol.device)
    mx, mn = g["mx"].clamp(min=-1e9), g["mn"].clamp(max=1e9)
    ticks = s[2] + s[3]
    out = {
        "open": g["open"], "high": g["high"], "low": g["low"], "close": g["close"],
        "volume": vol.to(f32), "vwap": vwap, "trades": g["count"],
        "median_trade_size": merged_median,
        "ticks_buy": s[2], "ticks_sell": s[3], "volume_buy": s[4].to(f32),
        "volume_sell": s[5].to(f32), "dollars_buy": s[6].to(f32), "dollars_sell": s[7].to(f32),
        "mean_spread": (s[8] / ticks).to(f32),
        "max_spread": torch.tensor(max(g["spread_max"], 0.0), dtype=f32),
        "cum_ticks_min": mn[0], "cum_ticks_max": mx[0],
        "cum_volume_min": mn[1].to(f32), "cum_volume_max": mx[1].to(f32),
        "cum_dollars_min": mn[2].to(f32), "cum_dollars_max": mx[2].to(f32)}
    return b, out


def sharded_bar_products(trades: TradeShard, ci, mesh: TimeMesh) -> dict:
    """OHLCV, VWAP, trade count, median trade size and the directional
    features of every bar, across the ranks: the keys and dtypes of
    ``bar/aggregate.py comp_bar_ohlcv`` and ``comp_bar_directional_features``
    (the ±1e9 start values of the imbalance extrema included), on the mesh's
    device, the same on every rank.

    ``trades`` holds float64 ``price``, float32 ``amount`` and int8 ``side``
    (:func:`shard_trades`); ``ci`` the global close indices (host or tensor,
    ``n_bars + 1``). Each rank runs ``comp_bar_ohlcv`` and
    ``comp_bar_directional_features`` (kernels S and C) on its span, the
    trade before it prepended, for the bars it owns; only the straddling
    bars are merged from their pieces (module docstring)."""
    ci_np = np.asarray(ci.cpu() if torch.is_tensor(ci) else ci, np.int64)
    bars = _Bars(mesh, trades, ci_np)
    dev = mesh.device
    ext = _extended(trades, mesh, ("price", "amount", "side"))
    # the owned bars over the extended span: trade -1 is the one before it
    ci_ext = torch.as_tensor(bars.ci_own + 1, device=dev)
    if bars.b1 > bars.b0:
        o = comp_bar_ohlcv(ext["price"], ext["amount"], ci_ext)
        o.update(comp_bar_directional_features(ext["price"], ext["amount"], ci_ext,
                                               ext["side"]))
    else:
        o = {k: torch.zeros(0, dtype=_F64, device=dev) for k in _PRODUCTS}
    # the straddling bars' medians (every rank takes part in the select)
    counts = np.diff(ci_np)
    med = None
    if len(bars.straddling):
        pair = _radix_select(mesh, trades, bars, trades["amount"].to(torch.float32),
                             _median_ks(counts)[:, bars.straddling])
        med = (pair[0].to(_F64) + pair[1].to(_F64)) * 0.5
    b_own = _own_straddler(bars)
    mine = _straddler_products(
        mesh, trades, bars, ext,
        None if b_own < 0 else med[int(np.searchsorted(bars.straddling, b_own))])
    rows = torch.stack([o[k].to(_F64) for k in _PRODUCTS])
    if mine is not None:
        for j, k in enumerate(_PRODUCTS):
            rows[j, 0] = torch.as_tensor(mine[1][k], dtype=_F64)
    full = _gather_owned(mesh, bars, rows)
    return {k: full[j].to(dt) for j, (k, dt) in enumerate(_PRODUCTS.items())}


def sharded_trade_size_features(trades: TradeShard, ci, theta, mesh: TimeMesh,
                                theta_mult: float = 5.0) -> dict:
    """The trade-size features of every bar across the ranks, as
    ``comp_bar_trade_size_features`` gives them (``theta`` float64 per bar):
    owned bars on each rank's span, straddling bars from their pieces' sums
    and the radix select's 95th-percentile brackets."""
    ci_np = np.asarray(ci.cpu() if torch.is_tensor(ci) else ci, np.int64)
    bars = _Bars(mesh, trades, ci_np)
    dev = mesh.device
    theta = torch.as_tensor(theta, dtype=_F64).to(dev)
    amt = trades["amount"]
    ci_own = torch.as_tensor(bars.ci_own, device=dev)
    if bars.b1 > bars.b0:
        f = comp_bar_trade_size_features(amt, theta[bars.b0:bars.b1], ci_own, theta_mult)
    else:
        f = {k: torch.zeros(0, dtype=torch.float32, device=dev)
             for k in ("mean_size_rel", "size_95_rel", "pct_block", "size_gini")}
    keys = list(f)
    rows = torch.stack([f[k].to(_F64) for k in keys])
    S = bars.straddling
    if len(S):
        counts = np.diff(ci_np)
        cm1 = np.maximum(counts, 1) - 1
        fr = Fraction(0.95).limit_denominator(10**6)
        k_lo = (cm1 * fr.numerator) // fr.denominator
        pair = _radix_select(mesh, trades, bars, amt.to(torch.float32),
                             np.stack([k_lo, np.minimum(k_lo + 1, cm1)])[:, S])
        thr = theta * float(theta_mult)
        # each rank's float64 sums over its pieces of every straddling bar
        part = torch.zeros((3, len(S)), dtype=_F64, device=dev)
        for j, b in enumerate(S.tolist()):
            pc = bars.piece(b)
            if pc is not None:
                a64 = amt[pc[0] + 1:pc[1] + 1].to(_F64)
                part[:, j] = fast_cumsum_cols(torch.stack([
                    a64, a64 * a64, torch.where(a64 > thr[b], a64, 0.0)]))[:, -1]
        sums = all_reduce(mesh, part, "sum")
        cnt = torch.as_tensor(counts[S], device=dev)
        pos = 0.95 * (cnt.clamp(min=1) - 1).to(_F64)
        frac = pos - torch.as_tensor(k_lo[S], device=dev).to(_F64)
        p95 = pair[0].to(_F64) * (1.0 - frac) + pair[1].to(_F64) * frac
        idx = torch.as_tensor(S, device=dev)
        g = trade_size_final(cnt, theta[idx], thr[idx], sums[0] / cnt.clamp(min=1).to(_F64),
                             sums[0], sums[1], sums[2], p95)
        b_own = _own_straddler(bars)
        if b_own >= 0:
            j = int(np.searchsorted(S, b_own))
            for r, k in enumerate(keys):
                rows[r, 0] = g[k][j].to(_F64)
    full = _gather_owned(mesh, bars, rows)
    return {k: full[j].to(torch.float32) for j, k in enumerate(keys)}
