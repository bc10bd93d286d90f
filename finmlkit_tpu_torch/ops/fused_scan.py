"""The bar scans of the trade stream: kernels B (``csrc/bar_products.cu``),
V (``csrc/bar_planes.cu``) and P (``csrc/io_floor.cu``).

Counterpart of ``finmlkit_tpu/ops/fused_scan.py``. Kernel B replaces the TPU
rowtail scans ``bar_scan_rowtails_v4`` (K1a) and ``bar_scan_rowtails`` (K1b,
v2), and absorbs the plane preparation and the boundary fixup that surround
them in ``finmlkit_tpu/bar/fused.py`` (``_prep_planes``, ``_boundary_state``).
It also serves ``bar_scan_rowtails_v3`` (K1d), a TPU layout experiment whose
output is K1b's bit for bit (``ops/fused_scan.py:1290-1301``).
It reads the trade arrays as they are (int32 ticks, int64 units, int8 sides,
int64 close indices) and writes, per bar, what ``_fused_packed_v2_jit``
returns:

- ``p64`` int64 (6, n_bars): vol_u, dollar_u, vol_buy_u, vol_sell_u,
  dol_buy_u, dol_sell_u;
- ``p32`` int32 (10, n_bars): open_raw, high_t, low_t, close_t, ticks_buy,
  ticks_sell, cum_spread_t, max_spread_t, ct_min, ct_max;
- ``pf`` float32 (4, n_bars): cv_min, cv_max, cd_min, cd_max.

Bar k holds trades ``(ci[k], ci[k+1]]``. An empty bar gets zero sums and
counts, sentinel extrema (``I32MIN``/``I32MAX``/``±F32BIG``) and the ticks at
the clamped positions ``ci[k]+1`` and ``ci[k+1]``; the JAX package leaves the
previous bar's extrema there instead, and the finals mask both.

:func:`bar_scan_planes` is the full-plane scan (K1c, ``bar_scan_planes`` v1):
the running state of every trade, its 9 global prefixes and 9 in-bar running
extrema, from kernel V, a segmented scan over fixed tiles of trades. :func:`bar_scan_io_floor` and its
two variants are the streaming-floor probes (P1-P3), all served by kernel P.
"""
import torch

from .. import _build
from ..utils import trace

__all__ = ["bar_scan_products", "bar_scan_products_plain", "bar_scan_products_tiles",
           "pair_to_f32",
           "prep_planes_plain", "bar_scan_planes", "bar_scan_planes_plain",
           "bar_scan_planes_tiles", "planes_prefix_inputs",
           "bar_scan_io_floor", "bar_scan_io_floor_k", "bar_scan_io_floor_stacked",
           "io_floor_plain", "I32MIN", "I32MAX", "F32BIG"]

# launches in the trace registry (utils/trace.py): launch.B, kernel B by
# bar_scan_products; launch.V, kernel V by bar_scan_planes (all its passes
# count 1); launch.P, kernel P by the bar_scan_io_floor probes

I32MIN = -2147483648
I32MAX = 2147483647
F32BIG = 3.0e38


def pair_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> float32 rounded in two steps, ``hi * 2^32 + f32(lo)``, as the
    TPU kernel's ``_pair_to_f32`` (``finmlkit_tpu/bar/fused.py:249-257``)."""
    hi = (x >> 32).to(torch.int32).to(torch.float32)
    lo = (x & 0xFFFFFFFF).to(torch.int32)  # low word as signed int32
    lo_f = lo.to(torch.float32) + (lo < 0).to(torch.float32) * 4294967296.0
    return hi * 4294967296.0 + lo_f


def _check_inputs(ticks, units, sides, ci):
    want = ((ticks, torch.int32, "ticks"), (units, torch.int64, "units"),
            (sides, torch.int8, "sides"), (ci, torch.int64, "ci"))
    for t, dt, name in want:
        if t.dim() != 1 or t.dtype != dt:
            raise TypeError(f"{name} must be a 1-D {dt} tensor, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != ticks.device:
            raise ValueError(f"{name} is on {t.device}, ticks on {ticks.device}")
    n = ticks.shape[0]
    if units.shape[0] != n or sides.shape[0] != n:
        raise ValueError("ticks, units and sides must have the same length")
    if ci.shape[0] < 2 or n == 0:
        raise ValueError("need at least one trade and one bar (len(ci) >= 2)")


def _valid(ci, n):
    """The trades inside some bar: ``(ci[0], ci[-1]]``."""
    idx = torch.arange(n, device=ci.device)
    return (idx > ci[0]) & (idx <= ci[-1])


def _spread(ticks, sides, ci, valid):
    """Tick-sign-change spread of every trade (``bar/fused.py _prep_planes``):
    the previous trade wraps to trade n-1 and does not reset at bar starts; a
    single-trade bar compares its side with 0; 0 outside every bar."""
    n = ticks.shape[0]
    single = torch.zeros(n + 1, dtype=torch.bool, device=ticks.device)
    single[torch.where(ci[1:] - ci[:-1] == 1, ci[1:], n)] = True
    change = torch.where(single[:n], sides != 0, sides != torch.roll(sides, 1))
    zero32 = torch.zeros((), dtype=torch.int32, device=ticks.device)
    return torch.where(valid & change, (ticks - torch.roll(ticks, 1)).abs(), zero32)


def bar_scan_products_plain(ticks, units, sides, ci):
    """Plain PyTorch version of :func:`bar_scan_products`, on any device.

    Sums are int64 prefix differences at the bar boundaries; extrema are
    ``scatter_reduce`` over the trade -> bar id; the in-bar running imbalances
    are global prefixes minus the prefix just before the bar's first trade.
    """
    _check_inputs(ticks, units, sides, ci)
    dev = ticks.device
    n, nb = ticks.shape[0], ci.shape[0] - 1
    i64 = torch.int64
    idx = torch.arange(n, device=dev)
    valid = _valid(ci, n)
    # bar k holds (ci[k], ci[k+1]]: the first k with ci[k+1] >= i
    bar = torch.searchsorted(ci[1:].contiguous(), idx)
    bar = torch.where(valid, bar, nb)  # slot nb collects the outside trades
    bar_c = bar.clamp(max=nb - 1)
    starts = ci[:-1] + 1
    zero64 = torch.zeros((), dtype=i64, device=dev)

    is_buy = valid & (sides == 1)
    is_sell = valid & (sides == -1)
    traded = valid & (sides != 0)
    u = torch.where(valid, units, zero64)
    d = ticks.to(i64) * u

    def prefix(v):
        return torch.cat([zero64.reshape(1), torch.cumsum(v, 0)])

    def bar_sum(v):
        p = prefix(v)
        return p[ci[1:] + 1] - p[starts]

    def in_bar_running(v):
        p = prefix(v)
        return p[1:] - p[starts[bar_c]]

    def bar_ext(v, init, how):
        out = torch.full((nb + 1,), init, dtype=v.dtype, device=dev)
        return out.scatter_reduce_(0, bar, v, how, include_self=True)[:nb]

    ub = torch.where(is_buy, u, zero64)
    us = torch.where(is_sell, u, zero64)
    db = torch.where(is_buy, d, zero64)
    ds = torch.where(is_sell, d, zero64)
    p64 = torch.stack([bar_sum(u), bar_sum(d), bar_sum(ub), bar_sum(us),
                       bar_sum(db), bar_sum(ds)])

    spread = _spread(ticks, sides, ci, valid)

    ct = in_bar_running(is_buy.to(i64) - is_sell.to(i64)).to(torch.int32)
    cv = pair_to_f32(in_bar_running(ub - us))
    cd = pair_to_f32(in_bar_running(db - ds))
    p32 = torch.stack([
        ticks[starts.clamp(0, n - 1)],
        bar_ext(ticks, I32MIN, "amax"),
        bar_ext(ticks, I32MAX, "amin"),
        ticks[ci[1:].clamp(0, n - 1)],
        bar_sum(is_buy.to(i64)).to(torch.int32),
        bar_sum(is_sell.to(i64)).to(torch.int32),
        bar_sum(spread.to(i64)).to(torch.int32),  # wraps mod 2^32 like the TPU
        bar_ext(spread, I32MIN, "amax"),
        bar_ext(torch.where(traded, ct, I32MAX), I32MAX, "amin"),
        bar_ext(torch.where(traded, ct, I32MIN), I32MIN, "amax"),
    ])
    pf = torch.stack([
        bar_ext(torch.where(traded, cv, F32BIG), F32BIG, "amin"),
        bar_ext(torch.where(traded, cv, -F32BIG), -F32BIG, "amax"),
        bar_ext(torch.where(traded, cd, F32BIG), F32BIG, "amin"),
        bar_ext(torch.where(traded, cd, -F32BIG), -F32BIG, "amax"),
    ])
    return p64, p32, pf


def _cuda_inputs(ticks, units, sides, ci, what):
    """Contiguous CUDA inputs of the bar scans' kernels; raises on a device
    other than CUDA, too many trades or bars, or close indices the kernels
    cannot take. It waits for the card (the check of ``ci``)."""
    if ticks.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {ticks.device}")
    n, nb = ticks.shape[0], ci.shape[0] - 1
    if n >= 2**31 - _TILE or nb >= 2**31:
        raise ValueError(f"{n} trades or {nb} bars exceed the kernels' int32 counts")
    ticks, units, sides, ci = (t.contiguous() for t in (ticks, units, sides, ci))
    ok = (ci[0] >= -1) & (ci[-1] < n) & torch.all(ci[1:] >= ci[:-1])
    if not trace.host_read(bool, ok):
        raise ValueError("ci must be sorted with -1 <= ci[0] and ci[-1] < n")
    return ticks, units, sides, ci


_TILE = 2048                 # trades a tile of kernel B (csrc/bar_products.cu kTile)
PRODUCTS_PASSES = ("marks", "tiles", "bars")


def bar_scan_products(ticks, units, sides, ci):
    """Per-bar products ``(p64, p32, pf)`` of the trade stream.

    On CUDA tensors this launches kernel B once (its three passes count one):
    a pass over fixed tiles of trades with an exact carry of the in-bar sums
    (:func:`bar_scan_products_tiles` models its decomposition); on CPU tensors
    it runs :func:`bar_scan_products_plain`. ``ci`` must be sorted, with
    ``-1 <= ci[0]`` and ``ci[-1] < len(ticks)``.
    """
    _check_inputs(ticks, units, sides, ci)
    if ticks.device.type == "cpu":
        return bar_scan_products_plain(ticks, units, sides, ci)
    args = _cuda_inputs(ticks, units, sides, ci, "bar_scan_products")
    bufs = _products_buffers(args[0].shape[0], ci.shape[0] - 1, ticks.device)
    _products_kernel(*args, bufs)
    trace.count("launch.B")
    return bufs[:3]


def _products_buffers(n, nb, device):
    """Kernel B's outputs ``(p64, p32, pf)`` and its scratch."""
    return (torch.empty((6, nb), dtype=torch.int64, device=device),
            torch.empty((10, nb), dtype=torch.int32, device=device),
            torch.empty((4, nb), dtype=torch.float32, device=device),
            torch.empty(_build.library().fmk_products_scratch_bytes(n, nb),
                        dtype=torch.uint8, device=device))


def _products_kernel(ticks, units, sides, ci, bufs, passes=(1 << len(PRODUCTS_PASSES)) - 1):
    """Kernel B's passes named by the bit mask ``passes`` (bit p: pass p of
    :data:`PRODUCTS_PASSES`) on inputs checked by :func:`_cuda_inputs`, into
    the buffers of :func:`_products_buffers`. One pass alone reads what the
    passes before it left in the scratch."""
    dev = ticks.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().fmk_bar_products(
            ticks.data_ptr(), units.data_ptr(), sides.data_ptr(), ci.data_ptr(),
            ticks.shape[0], ci.shape[0] - 1, *(b.data_ptr() for b in bufs),
            passes, stream)
    _build.check(rc, "bar_scan_products")


def _order_key(f):
    """float32 -> int32 key in the same order, for finite values (its own
    inverse)."""
    bits = f.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def bar_scan_products_tiles(ticks, units, sides, ci, tile: int):
    """CPU model of kernel B's decomposition, in plain torch on any device:
    the products of :func:`bar_scan_products_plain`, bit for bit, built as
    the kernel builds them from tiles of ``tile`` trades. A *segment* is the
    part of one bar inside one tile; the opens are the marks of every
    ``ci[k] + 1 < n``.

    1. Each tile's summary: whether a bar opens in it, and its last segment's
       in-bar sums ``(cv, cd, ct)``, exact.
    2. An exclusive scan of the summaries (sums add; an open on the right
       restarts): every tile's entry sums (the kernel's look-back).
    3. Each segment walked once from its entry sums (0 at an open, the tile's
       entry for its first segment), to its record of 24 words: the 6 int64
       and 3 int32 sums, and 9 int32 extrema taken by max (the minima bit
       inverted, the float extrema as order keys, ``I32MIN`` for none).
    4. The records joined into one a bar: a segment that opens and closes in
       its tile is stored; the others (a bar's part in a tile it did not
       open in, or did not close in) are joined by add and max into a
       record that starts at the identity, as the kernel's atomics join them.
    5. The products decoded from the records, empty bars from the identity.
    """
    _check_inputs(ticks, units, sides, ci)
    dev = ticks.device
    ticks, units, sides, ci = (t.cpu() for t in (ticks, units, sides, ci))
    n, nb = ticks.shape[0], ci.shape[0] - 1
    i32, i64 = torch.int32, torch.int64
    mark = _open_marks(ci, n)
    nxt = torch.cat([mark[1:], torch.ones(1, dtype=torch.bool)])
    buy, sell, traded = sides == 1, sides == -1, sides != 0
    zero64 = torch.zeros((), dtype=i64)
    d = ticks.to(i64) * units
    run = (buy.to(i32) - sell.to(i32),                           # ct, cv, cd
           torch.where(buy, units, torch.where(sell, -units, zero64)),
           torch.where(buy, d, torch.where(sell, -d, zero64)))
    # no validity: every trade of a bar is valid, and the segments outside
    # every bar are dropped whole
    change = torch.where(mark & nxt, sides != 0, sides != torch.roll(sides, 1))
    spread = torch.where(change, (ticks - torch.roll(ticks, 1)).abs(),
                         torch.zeros((), dtype=i32))
    bar_of = torch.searchsorted(ci, torch.arange(n) - 1, right=True) - 1
    bounds = [(a, min(a + tile, n)) for a in range(0, n, tile)]

    def opens_in(a, b):
        return [a + int(p) for p in torch.nonzero(mark[a:b]).reshape(-1)]

    def combine(x, y):
        """Two stretches' summaries ``(o, ct, cv, cd)``, ``x`` before ``y``."""
        if y[0]:
            return y
        return (x[0],) + tuple(u + v for u, v in zip(x[1:], y[1:]))

    # 1. summaries; 2. the entry sums of every tile
    entry = [(False, torch.zeros((), dtype=i32), zero64, zero64)]
    for a, b in bounds[:-1]:
        ops = opens_in(a, b)
        s = ops[-1] if ops else a
        entry.append(combine(entry[-1], (bool(ops),) + tuple(r[s:b].sum().to(r.dtype)
                                                           for r in run)))

    def none_to_min(x, ok):
        return x if ok else torch.tensor(I32MIN, dtype=i32)

    def record(s, e, base):
        """The 24 words of the segment [s, e) from the in-bar sums ``base``
        ``(ct, cv, cd)`` at s."""
        tr = traded[s:e]
        absolute = [b + torch.cumsum(r[s:e], 0, dtype=r.dtype) for b, r in zip(base, run)]
        ok = bool(tr.any())
        ct, cv, cd = (x[tr] for x in absolute)
        cvf, cdf = pair_to_f32(cv), pair_to_f32(cd)
        seg = slice(s, e)
        w64 = torch.stack([units[seg].sum(), d[seg].sum(), units[seg][buy[seg]].sum(),
                           d[seg][buy[seg]].sum(), run[1][seg].sum(), run[2][seg].sum()])
        w32 = torch.stack([buy[seg].sum(), run[0][seg].to(i64).sum(),
                           spread[seg].to(i64).sum()]).to(i32)
        m = [ticks[seg].max(), ~ticks[seg].min(), spread[seg].max()]
        m += [none_to_min(x, ok) for x in (
            ~ct.min() if ok else 0, ct.max() if ok else 0,
            _order_key(cvf.max()) if ok else 0, ~_order_key(cvf.min()) if ok else 0,
            _order_key(cdf.max()) if ok else 0, ~_order_key(cdf.min()) if ok else 0)]
        return w64, w32, torch.stack([torch.as_tensor(x, dtype=i32) for x in m])

    # 3. every segment; 4. joined into the bars' records
    r64 = torch.zeros((nb, 6), dtype=i64)
    r32 = torch.zeros((nb, 3), dtype=i32)
    rmax = torch.full((nb, 9), I32MIN, dtype=i32)
    stored, joined = set(), set()
    for (a, b), (_, *base) in zip(bounds, entry):
        ops = opens_in(a, b)
        closes = b == n or bool(mark[b])
        starts = ([a] if not ops or ops[0] != a else []) + ops
        for j, s in enumerate(starts):
            e = starts[j + 1] if j + 1 < len(starts) else b
            k = int(bar_of[s])
            if not 0 <= k < nb:
                continue             # outside every bar
            opened = bool(mark[s])
            w64, w32, wm = record(s, e, base if not opened else
                                  (torch.zeros((), dtype=i32), zero64, zero64))
            if opened and (e < b or closes):
                assert k not in stored and k not in joined
                stored.add(k)
                r64[k], r32[k], rmax[k] = w64, w32, wm
            else:
                assert k not in stored
                joined.add(k)
                r64[k] += w64
                r32[k] += w32
                rmax[k] = torch.maximum(rmax[k], wm)
    # 5. the products
    first = (ci[:-1] + 1).clamp(0, n - 1)
    last = ci[1:].clamp(0, n - 1)
    vol, dol, vb, db, cvs, cds = r64.T
    tb, cts, sp = r32.T
    hi, nlo, spmax, nctmin, ctmax, kvmax, nkvmin, kdmax, nkdmin = rmax.T

    def fl(word, sentinel):
        """A float extremum from its word: the key, bit inverted for a minimum."""
        key = ~word if sentinel > 0 else word
        return torch.where(word == I32MIN, torch.tensor(sentinel, dtype=torch.float32),
                           _order_key(key).view(torch.float32))

    p64 = torch.stack([vol, dol, vb, vb - cvs, db, db - cds])
    p32 = torch.stack([ticks[first], hi, ~nlo, ticks[last], tb, tb - cts, sp, spmax,
                       ~nctmin, ctmax])
    pf = torch.stack([fl(nkvmin, F32BIG), fl(kvmax, -F32BIG),
                      fl(nkdmin, F32BIG), fl(kdmax, -F32BIG)])
    return p64.to(dev), p32.to(dev), pf.to(dev)


# ---------------------------------------------------------------------------
# Full planes (K1c): kernel V
# ---------------------------------------------------------------------------

def prep_planes_plain(ticks, units, sides, ci):
    """The 8 int32 input streams of the TPU bar scans (``bar/fused.py
    _prep_planes``), flat, without the ``(rows, 128)`` shape or padding:
    ticks, units low and high words, dollars (ticks * units) low and high
    words, sides, flags (bit 0: inside some bar; bit 1: a bar opens here, at
    every ``ci[k] + 1 < n``) and the spread. Units, dollars, sides and spread
    are 0 outside every bar."""
    _check_inputs(ticks, units, sides, ci)
    n = ticks.shape[0]
    valid = _valid(ci, n)
    u = torch.where(valid, units, 0)
    d = ticks.to(torch.int64) * u
    return (ticks, u.to(torch.int32), (u >> 32).to(torch.int32),
            d.to(torch.int32), (d >> 32).to(torch.int32),
            torch.where(valid, sides.to(torch.int32), 0),
            valid.to(torch.int32) | (_open_marks(ci, n).to(torch.int32) << 1),
            _spread(ticks, sides, ci, valid))


def _open_marks(ci, n):
    """Bool mask of the bar-open positions, every ``ci[k] + 1 < n``."""
    marks = torch.zeros(n + 1, dtype=torch.bool, device=ci.device)
    marks[torch.where(ci + 1 < n, (ci + 1).clamp(min=0), n)] = True
    return marks[:n]


def planes_prefix_inputs(ticks, units, sides, ci):
    """The rows whose prefix sums are the planes' global prefixes, built from
    the trades in place: int64 ``(6, n)`` buy units, sell units, buy dollars,
    sell dollars, units, dollars; int32 ``(3, n)`` buy ticks, sell ticks,
    spread; all 0 outside every bar."""
    n = ticks.shape[0]
    valid = _valid(ci, n)
    side = torch.where(valid, sides, 0)
    buy, sell = side == 1, side == -1
    in64 = torch.empty((6, n), dtype=torch.int64, device=ticks.device)
    u, d = in64[4], in64[5]
    torch.mul(units, valid, out=u)
    torch.mul(ticks, u, out=d)
    for row, (x, m) in enumerate(((u, buy), (u, sell), (d, buy), (d, sell))):
        torch.mul(x, m, out=in64[row])
    in32 = torch.empty((3, n), dtype=torch.int32, device=ticks.device)
    in32[0], in32[1] = buy, sell
    in32[2] = _spread(ticks, sides, ci, valid)
    return in64, in32


def _seg_extremum(v, seg, how):
    """Running max or min of ``v`` (int32 or float32) that restarts where
    ``seg`` (a nondecreasing int64 segment id) steps: ``torch.cummax`` or
    ``cummin`` of the int64 key ``(±seg << 32) | order-preserving bits``."""
    if v.dtype == torch.float32:
        bits = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        order = torch.where(bits >> 31 == 1, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    else:
        order = v.to(torch.int64) + 2**31
    if how == "max":
        key = torch.cummax((seg << 32) | order, 0).values
    else:
        key = torch.cummin(((-seg) << 32) | order, 0).values
    low = key & 0xFFFFFFFF
    if v.dtype == torch.float32:
        bits = torch.where(low >> 31 == 1, low & 0x7FFFFFFF, ~low & 0xFFFFFFFF)
        return bits.to(torch.int32).view(torch.float32)
    return (low - 2**31).to(torch.int32)


def bar_scan_planes_plain(ticks, units, sides, ci):
    """Plain PyTorch version of :func:`bar_scan_planes`, on any device: the
    TPU kernel's definitions over the streams of :func:`planes_prefix_inputs`,
    with ``torch.cumsum`` for the prefixes and ``torch.cummax``/``cummin`` on
    segment-keyed values for the running extrema."""
    _check_inputs(ticks, units, sides, ci)
    tk, n = ticks, ticks.shape[0]
    in64, in32 = planes_prefix_inputs(ticks, units, sides, ci)
    pre64 = torch.cumsum(in64, 1)
    pre32 = torch.cumsum(in32, 1, dtype=torch.int32)
    valid, mark, spread = _valid(ci, n), _open_marks(ci, n), in32[2]
    traded = valid & (sides != 0)
    seg = torch.cumsum(mark, 0)
    idx = torch.arange(n, device=tk.device)
    last = torch.cummax(torch.where(mark, idx, -1), 0).values

    def in_bar(p, x):
        """Running in-bar value: the prefix minus its value just before the
        bar's first trade (0 before the first mark)."""
        e = p - x
        base = torch.where(last >= 0, e[last.clamp(min=0)], torch.zeros_like(e[:1]))
        return p - base

    ct = in_bar(pre32[0] - pre32[1], in32[0] - in32[1])
    cv = pair_to_f32(in_bar(pre64[0] - pre64[1], in64[0] - in64[1]))
    cd = pair_to_f32(in_bar(pre64[2] - pre64[3], in64[2] - in64[3]))
    ext32 = torch.stack([
        _seg_extremum(torch.where(valid, tk, I32MIN), seg, "max"),
        _seg_extremum(torch.where(valid, tk, I32MAX), seg, "min"),
        _seg_extremum(torch.where(valid, spread, -1), seg, "max"),
        _seg_extremum(torch.where(traded, ct, I32MAX), seg, "min"),
        _seg_extremum(torch.where(traded, ct, I32MIN), seg, "max")])
    extf = torch.stack([
        _seg_extremum(torch.where(traded, cv, F32BIG), seg, "min"),
        _seg_extremum(torch.where(traded, cv, -F32BIG), seg, "max"),
        _seg_extremum(torch.where(traded, cd, F32BIG), seg, "min"),
        _seg_extremum(torch.where(traded, cd, -F32BIG), seg, "max")])
    return pre64, pre32, ext32, extf


def bar_scan_planes(ticks, units, sides, ci):
    """The running scan state of every trade, ``(pre64, pre32, ext32,
    extf)``:

    - ``pre64`` int64 ``(6, n)``: prefix sums of buy units, sell units, buy
      dollars, sell dollars, units and dollars (wrapping);
    - ``pre32`` int32 ``(3, n)``: prefix sums of buy ticks, sell ticks and the
      spread (wrapping);
    - ``ext32`` int32 ``(5, n)``: the running high, low and max spread of the
      bar so far, and the min and max of its running tick imbalance;
    - ``extf`` float32 ``(4, n)``: the min and max of the bar's running
      volume and dollar imbalances.

    Outside every bar the inputs count 0 and the extrema hold the sentinels
    (``I32MIN``, ``I32MAX``, -1, ``I32MAX``, ``I32MIN``, ``±F32BIG``), as in
    the TPU kernel. On CUDA tensors this launches kernel V once: a segmented
    scan over fixed tiles of trades (:func:`bar_scan_planes_tiles` models its
    decomposition); on CPU tensors it runs :func:`bar_scan_planes_plain`.
    """
    _check_inputs(ticks, units, sides, ci)
    if ticks.device.type == "cpu":
        return bar_scan_planes_plain(ticks, units, sides, ci)
    ticks, units, sides, ci = _cuda_inputs(ticks, units, sides, ci,
                                           "bar_scan_planes")
    bufs = _planes_buffers(ticks.shape[0], ticks.device)
    _planes_kernel(ticks, units, sides, ci, bufs)
    trace.count("launch.V")
    return bufs[:4]


PLANES_PASSES = ("marks", "reduce", "scan", "float reduce", "float scan", "write")


def _planes_buffers(n, device):
    """Kernel V's outputs ``(pre64, pre32, ext32, extf)`` and its scratch."""
    return (torch.empty((6, n), dtype=torch.int64, device=device),
            torch.empty((3, n), dtype=torch.int32, device=device),
            torch.empty((5, n), dtype=torch.int32, device=device),
            torch.empty((4, n), dtype=torch.float32, device=device),
            torch.empty(_build.library().fmk_planes_scratch_bytes(n),
                        dtype=torch.uint8, device=device))


def _planes_kernel(ticks, units, sides, ci, bufs, passes=(1 << len(PLANES_PASSES)) - 1):
    """Kernel V's passes named by the bit mask ``passes`` (bit p: pass p of
    :data:`PLANES_PASSES`) on checked contiguous CUDA inputs, into the
    buffers of :func:`_planes_buffers`. One pass alone reads what the passes
    before it left in the scratch."""
    dev = ticks.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().fmk_bar_planes(
            ticks.data_ptr(), units.data_ptr(), sides.data_ptr(), ci.data_ptr(),
            ticks.shape[0], ci.shape[0] - 1, *(b.data_ptr() for b in bufs),
            passes, stream)
    _build.check(rc, "bar_scan_planes")


def bar_scan_planes_tiles(ticks, units, sides, ci, tile: int):
    """CPU model of kernel V's decomposition, in plain torch on any device:
    the planes of :func:`bar_scan_planes_plain`, bit for bit, built as the
    kernel builds them from tiles of ``tile`` trades.

    1. Each tile's summary: its 9 sums, whether a bar opens in it, and its
       last segment's (from its last open, or from its start) in-bar sums and
       5 integer running extrema, the tick imbalance's relative to the
       segment's own start.
    2. An exclusive scan of the summaries under the segmented operator (sums
       add; an open on the right restarts the in-bar state): every tile's
       entry prefixes, in-bar sums and integer extrema, exact.
    3. Each tile's float extrema of its last segment, from that segment's
       exact entry sums. They are not carried as int64 extrema and rounded
       once: ``pair_to_f32`` drops at -2^56, and an in-bar sum may wrap.
    4. An exclusive scan of those: every tile's entry float extrema.
    5. Each tile re-walked from its entry state.
    """
    _check_inputs(ticks, units, sides, ci)
    dev = ticks.device
    ticks, units, sides, ci = (t.cpu() for t in (ticks, units, sides, ci))
    n = ticks.shape[0]
    i32, i64 = torch.int32, torch.int64
    in64, in32 = planes_prefix_inputs(ticks, units, sides, ci)
    valid, mark = _valid(ci, n), _open_marks(ci, n)
    traded = valid & (sides != 0)
    run = (in32[0] - in32[1], in64[0] - in64[1], in64[2] - in64[3])  # ct, cv, cd
    vals32 = torch.stack([torch.where(valid, ticks, I32MIN),
                          torch.where(valid, ticks, I32MAX),
                          torch.where(valid, in32[2], -1)])
    how32 = ("max", "min", "max", "min", "max")
    howf = ("min", "max", "min", "max")
    bounds = [(a, min(a + tile, n)) for a in range(0, n, tile)]
    zero32, zero64 = torch.zeros((), dtype=i32), torch.zeros((), dtype=i64)
    ext_id = torch.tensor([I32MIN, I32MAX, I32MIN, I32MAX, I32MIN], dtype=i32)
    fid = torch.tensor([F32BIG, -F32BIG, F32BIG, -F32BIG], dtype=torch.float32)

    def pick(x, how):
        return x.max() if how == "max" else x.min()

    def last_open(a, b):
        opens = torch.nonzero(mark[a:b]).reshape(-1)
        return bool(len(opens)), a + int(opens[-1]) if len(opens) else a

    def combine(x, y):
        """Two stretches' summaries, ``x`` before ``y``."""
        s64, s32 = x["s64"] + y["s64"], x["s32"] + y["s32"]
        if y["o"]:
            return dict(y, s64=s64, s32=s32)
        e = y["e"].clone()
        shift = (e != ext_id) & torch.tensor([False, False, False, True, True])
        e = torch.where(shift, e + x["r"][0], e)
        e = torch.stack([pick(torch.stack([u, v]), h)
                         for u, v, h in zip(x["e"], e, how32)])
        return dict(o=x["o"], s64=s64, s32=s32, e=e,
                    r=tuple(u + v for u, v in zip(x["r"], y["r"])))

    # 1. summaries
    tiles = []
    for a, b in bounds:
        o, s = last_open(a, b)
        ct = torch.cumsum(run[0][s:b], 0, dtype=i32)
        tr = traded[s:b]
        e = [pick(vals32[k, s:b], how32[k]) for k in range(3)]
        e += [torch.where(tr, ct, I32MAX).min(), torch.where(tr, ct, I32MIN).max()]
        tiles.append(dict(o=o, s64=in64[:, a:b].sum(1), s32=in32[:, a:b].sum(1, dtype=i32),
                          r=(ct[-1], run[1][s:b].sum(), run[2][s:b].sum()),
                          e=torch.stack(e)))
    # 2. the entry state of every tile
    entry = [dict(o=False, s64=torch.zeros(6, dtype=i64), s32=torch.zeros(3, dtype=i32),
                  r=(zero32, zero64, zero64), e=ext_id)]
    for x in tiles[:-1]:
        entry.append(combine(entry[-1], x))

    def in_bar(k, a, b, base):
        """In-bar running sums over [a, b) from ``base`` at ``a``."""
        idx = torch.arange(b - a)
        p = torch.cumsum(run[k][a:b], 0, dtype=run[k].dtype)
        lm = torch.cummax(torch.where(mark[a:b], idx, -1), 0).values
        e = p - run[k][a:b]
        return torch.where(lm >= 0, p - e[lm.clamp(min=0)], base + p)

    def floats(a, b, base_cv, base_cd):
        return [pair_to_f32(in_bar(k, a, b, base)) for k, base in
                ((1, base_cv), (1, base_cv), (2, base_cd), (2, base_cd))]

    # 3. float extrema of each tile's last segment; 4. their entries
    fentry = [(False, fid)]
    for (a, b), x, t in zip(bounds[:-1], tiles, entry):
        o, s = last_open(a, b)
        base = (zero64, zero64) if o else t["r"][1:]
        fe = torch.stack([pick(torch.where(traded[s:b], v, fid[k]), howf[k])
                          for k, v in enumerate(floats(s, b, *base))])
        po, pfe = fentry[-1]
        if not o:
            fe = torch.where(torch.tensor([True, False, True, False]),
                             torch.minimum(pfe, fe), torch.maximum(pfe, fe))
        fentry.append((po or o, fe))
    # 5. every tile from its entry state
    pre64 = torch.empty((6, n), dtype=i64)
    pre32 = torch.empty((3, n), dtype=i32)
    ext32 = torch.empty((5, n), dtype=i32)
    extf = torch.empty((4, n), dtype=torch.float32)
    for (a, b), t, (_, fe) in zip(bounds, entry, fentry):
        pre64[:, a:b] = t["s64"][:, None] + torch.cumsum(in64[:, a:b], 1)
        pre32[:, a:b] = t["s32"][:, None] + torch.cumsum(in32[:, a:b], 1, dtype=i32)
        seg = torch.cumsum(mark[a:b], 0)
        ct = in_bar(0, a, b, t["r"][0])
        tr = traded[a:b]
        v32 = [vals32[0, a:b], vals32[1, a:b], vals32[2, a:b],
               torch.where(tr, ct, I32MAX), torch.where(tr, ct, I32MIN)]
        vf = [torch.where(tr, v, fid[k]) for k, v in
              enumerate(floats(a, b, t["r"][1], t["r"][2]))]
        for out, vs, hows, carry in ((ext32, v32, how32, t["e"]), (extf, vf, howf, fe)):
            for k, (v, h) in enumerate(zip(vs, hows)):
                x = _seg_extremum(v, seg, h)
                joined = torch.maximum(x, carry[k]) if h == "max" else torch.minimum(x, carry[k])
                out[k, a:b] = torch.where(seg == 0, joined, x)
    return pre64.to(dev), pre32.to(dev), ext32.to(dev), extf.to(dev)


# ---------------------------------------------------------------------------
# Streaming-floor probes (P1-P3): kernel P
# ---------------------------------------------------------------------------

def io_floor_plain(streams) -> torch.Tensor:
    """Plain PyTorch version of the probes, on any device: the int32 sum
    (wrapping) of a ``(k, n)`` tensor's rows or of a sequence of k streams,
    one ``torch.sum``."""
    x = streams if torch.is_tensor(streams) else torch.stack(list(streams))
    return torch.sum(x, 0, dtype=torch.int32)


def _io_floor(rows, what) -> torch.Tensor:
    if not 1 <= len(rows) <= 8:
        raise ValueError(f"{what} sums 1 to 8 streams, got {len(rows)}")
    x0 = rows[0]
    for x in rows:
        if x.dim() != 1 or x.dtype != torch.int32 or x.shape != x0.shape \
                or x.device != x0.device or not x.is_contiguous():
            raise TypeError(f"{what} takes contiguous 1-D int32 streams of one "
                            "length and device")
    if x0.device.type == "cpu":
        return io_floor_plain(rows)
    if x0.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x0.device}")
    out = torch.empty_like(x0)
    ptrs = [x.data_ptr() for x in rows] + [0] * (8 - len(rows))
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = _build.library().fmk_io_floor(*ptrs, len(rows), out.data_ptr(),
                                           x0.shape[0], stream)
    trace.count("launch.P")
    _build.check(rc, what)
    return out


def bar_scan_io_floor(ticks, ulo, uhi, dlo, dhi, side, flags, spread):
    """P1: the int32 sum of the bar scan's 8 input streams (those of
    :func:`prep_planes_plain`), the floor of a kernel that reads them. Kernel
    P on CUDA tensors, :func:`io_floor_plain` on CPU tensors."""
    return _io_floor((ticks, ulo, uhi, dlo, dhi, side, flags, spread),
                     "bar_scan_io_floor")


def bar_scan_io_floor_k(x, k: int = 1):
    """P2: the sum of ``k`` copies of one int32 stream (k <= 8)."""
    return _io_floor((x,) * k, "bar_scan_io_floor_k")


def bar_scan_io_floor_stacked(x):
    """P3: the sum over the rows of one ``(8, n)`` int32 stack. Kernel P reads
    the stack through its one pointer with 16-byte loads, whatever the rows'
    alignment; :func:`io_floor_plain` on CPU tensors."""
    what = "bar_scan_io_floor_stacked"
    if x.dim() != 2 or x.shape[0] != 8:
        raise ValueError(f"{what} takes an (8, n) stack, got {tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what} takes int32, got {x.dtype}")
    if x.device.type == "cpu":
        return io_floor_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    x = x.contiguous()
    out = torch.empty(x.shape[1], dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _build.library().fmk_io_floor_stacked(x.data_ptr(), x.shape[0],
                                                   x.shape[1], out.data_ptr(), stream)
    trace.count("launch.P")
    _build.check(rc, what)
    return out
