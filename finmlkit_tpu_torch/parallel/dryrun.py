"""Drive the whole time-sharded layer on local ranks and hold it to the
single-device functions.

Counterpart of ``dryrun_multichip`` (``__graft_entry__.py:63-186``): all seven
sharded indexers, the bar products, an EWMA on the closes, the footprints and
their rolling profile, and the triple barrier sharded over events with its
weights, each against the port's single-device function on the same device.
Run it as

    python -m finmlkit_tpu_torch.parallel.dryrun --ranks 4 [--device cpu]

(``--backend nccl`` with ``--ranks 1`` on a card). ``--ingest`` runs the flow
of ``examples/multihost_ingest.py`` instead: a store of three months in a
temporary directory, loaded by the ranks (``ingest.load_store_to_mesh``),
time bars and their products on the mesh against the same months loaded on
one device; it needs ``h5py``.

The rank functions here are also what the parity tests and ``chip_smoke.py``
phase 14 run on their ranks: :func:`indexer_cases`, :func:`layer_cases` and
:func:`on_worlds` (a group of 4 ranks runs every case on its first rank, its
first 3 with uneven spans, and all 4).
"""
import argparse
import datetime
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..bar import aggregate, footprint, indexers
from ..feature.kernels.ma import ewma
from ..feature.kernels.volume import volume_profile_rolling
from ..label.tbm import triple_barrier
from ..label.weights import average_uniqueness, return_attribution
from ..sampling.filters import cusum_filter
from . import sharded_indexers as si
from .mesh import DEFAULT_TIMEOUT, TimeMesh, spawn_mesh, time_mesh
from ..ops.segment import bar_ids_from_close_indices, sorted_segments
from .sharded import (gather_ragged, shard_trades, sharded_bar_products,
                      sharded_median_trade_size, sharded_segment_kth,
                      sharded_trade_size_features)
from .sharded_footprint import sharded_bar_footprints, sharded_volume_profile_rolling
from ..utils import trace

__all__ = ["synth_trades", "uneven_spans", "indexer_cases", "single_indexers",
           "product_cases", "single_products", "footprint_cases", "single_footprints",
           "layer_cases", "single_layer", "on_worlds", "suite", "pin_streams", "pin_cases",
           "footprint_pin", "mesh_check", "month_path", "launch_counts", "main"]

TICK = 0.01          # the synthetic prices' grid
DYADIC_TICK = 1 / 16  # the dyadic prices' grid
INDEXERS = ("time", "tick", "volume", "volume_q", "dollar", "dollar_q", "cusum",
            "imbalance", "imbalance_fixed", "run", "run_volume")


def synth_trades(n: int, seed: int = 7, dyadic: bool = False):
    """``__graft_entry__.py``'s synthetic trades (70 ms spacing, prices on a
    cent grid, lognormal amounts, +-1 sides) with one trade in twenty at the
    timestamp before it (same-print blocks): ``(ts, price, amount, side)``.
    ``dyadic=True`` puts the prices on sixteenths and the amounts on 64ths
    (below 8), as the JAX package's sharded tests do, so that float64 sums of
    them do not round."""
    r = np.random.default_rng(seed)
    dt = (r.exponential(70.0, n) * 1e6).astype(np.int64)
    dt[r.random(n) < 0.05] = 0
    ts = 1_700_000_000_000_000_000 + np.cumsum(dt)
    price = np.round(100.0 * np.exp(np.cumsum(r.normal(0, 1e-4, n))), 2)
    amount = np.maximum(np.round(r.lognormal(-2.5, 1.2, n), 5), 1e-5).astype(np.float32)
    side = np.where(r.random(n) < 0.5, 1, -1).astype(np.int8)
    if dyadic:
        price = np.round(price * 16.0) / 16.0
        amount = (r.integers(1, 512, n) / 64.0).astype(np.float32)
    return ts, price, amount, side


def uneven_spans(n: int, world: int):
    """Contiguous spans of weights 1, 2, ..., world."""
    cuts = [n * k * (k + 1) // (world * (world + 1)) for k in range(world + 1)]
    return tuple(zip(cuts[:-1], cuts[1:]))


def _params(cols):
    """The indexers' thresholds on a stream: a few hundred bars each."""
    ts, price, amount, side = cols
    n = len(ts)
    units = np.round(amount.astype(np.float64) * 1e5).astype(np.int64)
    ticks = np.round(price / TICK).astype(np.int64)
    sigma = np.full(n, 1e-4)
    sigma[:37] = np.nan                          # a leading gap, and one inside
    sigma[n // 3:n // 3 + 50] = np.nan
    # thresholds on 64ths: with dyadic trades every sum and remainder is exact
    return dict(interval=float(max(round(float(ts[-1] - ts[0]) / 1e9 / 300), 1)),
                ticks_per_bar=max(n // 300, 2),
                vol=round(float(amount.astype(np.float64).sum()) / 300 * 64) / 64,
                dol=round(float((price * amount).sum()) / 300 * 64) / 64, units=units,
                ticks=ticks, sigma=sigma)


def indexer_cases(mesh: TimeMesh, cols, spans=None) -> dict:
    """Every sharded indexer on ``cols`` (the whole stream's host columns):
    ``{case: ci}`` (host int64). ``spans`` gives each rank its own span and
    offset; by default each rank slices the whole stream's columns itself."""
    ts, price, amount, side = cols
    p = _params(cols)
    if spans is None:
        sl, kw = (lambda x: x), {}
    else:
        lo, hi = spans[mesh.rank]
        sl, kw = (lambda x: x[lo:hi]), {"offset": lo}
    t, px, a, s = sl(ts), sl(price), sl(amount), sl(side)
    ema = dict(expected_ticks_init=16.0, alpha_ticks=0.1, alpha_rate=0.1)
    calls = {
        "time": lambda: si.sharded_time_bar_indexer(t, p["interval"], mesh, **kw),
        "tick": lambda: si.sharded_tick_bar_indexer(t, p["ticks_per_bar"], mesh, **kw),
        "volume": lambda: si.sharded_volume_bar_indexer(t, a, p["vol"], mesh, **kw),
        "volume_q": lambda: si.sharded_volume_bar_indexer(
            t, None, p["vol"], mesh, amount_units=sl(p["units"]), amount_scale=1e-5, **kw),
        "dollar": lambda: si.sharded_dollar_bar_indexer(t, px, a, p["dol"], mesh, **kw),
        "dollar_q": lambda: si.sharded_dollar_bar_indexer(
            t, None, None, p["dol"], mesh, price_ticks=sl(p["ticks"]),
            amount_units=sl(p["units"]), tick_size=TICK, amount_scale=1e-5, **kw),
        "cusum": lambda: si.sharded_cusum_bar_indexer(t, px, sl(p["sigma"]), 1e-9, 3.0,
                                                      mesh, **kw),
        "imbalance": lambda: si.sharded_imbalance_bar_indexer(
            t, s, expected_rate_init=0.2, mesh=mesh, **ema, **kw),
        "imbalance_fixed": lambda: si.sharded_imbalance_bar_indexer(
            t, s, threshold=20.0, mesh=mesh, **kw),
        "run": lambda: si.sharded_run_bar_indexer(t, s, expected_rate_init=0.6, mesh=mesh,
                                                  **ema, **kw),
        "run_volume": lambda: si.sharded_run_bar_indexer(
            t, s, a, threshold=float(np.median(amount)) * 20, mesh=mesh, **kw),
    }
    return {name: np.asarray(calls[name]()[1]) for name in INDEXERS}


def single_indexers(cols, device) -> dict:
    """The single-device indexers of :func:`indexer_cases`'s cases."""
    ts, price, amount, side = (torch.from_numpy(np.ascontiguousarray(c)).to(device)
                               for c in cols)
    p = _params(cols)
    T = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    ema = dict(expected_ticks_init=16.0, alpha_ticks=0.1, alpha_rate=0.1)
    calls = {
        "time": lambda: indexers.time_bar_indexer(ts, p["interval"]),
        "tick": lambda: indexers.tick_bar_indexer(ts, p["ticks_per_bar"]),
        "volume": lambda: indexers.volume_bar_indexer(ts, amount, p["vol"]),
        "volume_q": lambda: indexers.volume_bar_indexer_q(ts, T(p["units"]), p["vol"], 1e-5),
        "dollar": lambda: indexers.dollar_bar_indexer(ts, price, amount, p["dol"]),
        "dollar_q": lambda: indexers.dollar_bar_indexer_q(ts, T(p["ticks"]), T(p["units"]),
                                                          p["dol"], TICK, 1e-5),
        "cusum": lambda: indexers.cusum_bar_indexer(ts, price, T(p["sigma"]), 1e-9, 3.0),
        "imbalance": lambda: indexers.imbalance_bar_indexer(ts, side, expected_rate_init=0.2,
                                                            **ema),
        "imbalance_fixed": lambda: indexers.imbalance_bar_indexer(ts, side, threshold=20.0),
        "run": lambda: indexers.run_bar_indexer(ts, side, expected_rate_init=0.6, **ema),
        "run_volume": lambda: indexers.run_bar_indexer(
            ts, side, amount, threshold=float(np.median(cols[2])) * 20),
    }
    return {name: calls[name]()[1].cpu().numpy() for name in INDEXERS}


def _events(close, device):
    """CUSUM events (0.1%) on the bars' closes, inside the bars, and a target
    of 0.1% each."""
    ev = cusum_filter(close, 1e-3)
    ev = ev[(ev > 0) & (ev < close.shape[0] - 1)]
    tgt = torch.full(ev.shape, 1e-3, dtype=torch.float64, device=device)
    return ev, tgt


def _trades(mesh, cols, spans):
    """This rank's :class:`TradeShard` of ``cols``: its span of the whole
    stream's columns, or (``spans``) its own span passed with its offset."""
    ts, price, amount, side = cols
    if spans is None:
        return shard_trades({"ts": ts, "price": price, "amount": amount, "side": side}, mesh)
    lo, hi = spans[mesh.rank]
    return shard_trades({"ts": ts[lo:hi], "price": price[lo:hi], "amount": amount[lo:hi],
                         "side": side[lo:hi]}, mesh, offset=lo)


def _kth_ranks(ci):
    counts = np.diff(np.asarray(ci))
    return np.stack([np.maximum(counts - 1, 0) * 3 // 7, np.maximum(counts - 1, 0)])


def product_cases(mesh: TimeMesh, cols, spans=None, tick: float = TICK) -> dict:
    """The time bars' products, trade-size features, medians and two order
    statistics (``sharded_segment_kth``), an EWMA of 10 on the closes, and the
    triple barrier on the bars, sharded over CUSUM events, with uniqueness and
    attribution weights, each on the mesh: ``{case: host array}``."""
    ts, price, amount, side = cols
    p = _params(cols)
    dev = mesh.device
    tr = _trades(mesh, cols, spans)
    clock, ci = si.sharded_time_bar_indexer(tr["ts"], p["interval"], mesh, offset=tr.lo)
    clock = torch.from_numpy(clock)
    out = {}
    prod = sharded_bar_products(tr, ci, mesh)
    out.update({f"products.{k}": v for k, v in prod.items()})
    theta = np.full(len(ci) - 1, float(np.median(amount)))
    out.update({f"trade_size.{k}": v for k, v in
                sharded_trade_size_features(tr, ci, theta, mesh).items()})
    out["median"] = sharded_median_trade_size(tr, ci, mesh)
    out["kth"] = sharded_segment_kth(tr["amount"], ci, _kth_ranks(ci), mesh, offset=tr.lo)
    close = prod["close"]
    out["ewma"] = ewma(close, 10, device=dev)
    # the triple barrier over the bars, each rank its span of the events
    bars_ts = clock[1:ci.shape[0]].to(dev)
    ev, tgt = _events(close, dev)
    e0, e1 = mesh.span(ev.shape[0])
    labels = [torch.zeros(0, dtype=dt, device=dev)
              for dt in (torch.int8, torch.int64, torch.float64, torch.float64)]
    if e1 > e0:
        labels = triple_barrier(bars_ts, close, ev[e0:e1], tgt[e0:e1], (1.0, 1.0), 1800.0)
    labels = [gather_ragged(mesh, x) for x in labels]
    out.update({f"labels.{i}": x for i, x in enumerate(labels)})
    w_u, conc = average_uniqueness(bars_ts, ev, labels[1])
    out["w_u"] = w_u
    out["w_r"] = return_attribution(ev, labels[1], close, conc)
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v) for k, v in out.items()}


def footprint_cases(mesh: TimeMesh, cols, spans=None, tick: float = TICK) -> dict:
    """The dollar bars' footprints on ``tick`` and their rolling profile (600
    s, 5 bins), on the mesh: ``{case: host array}``."""
    ts, price, amount, side = cols
    p = _params(cols)
    tr = _trades(mesh, cols, spans)
    _, ci_d = si.sharded_dollar_bar_indexer(tr["ts"], tr["price"], tr["amount"], p["dol"],
                                            mesh, offset=tr.lo)
    dprod = sharded_bar_products(tr, ci_d, mesh)
    fp = sharded_bar_footprints(tr, ci_d, dprod["low"], dprod["high"], tick, 3.0, mesh)
    out = {"ci": ci_d}
    out.update({f"footprints.{k}": v for k, v in fp.items()})
    prof = sharded_volume_profile_rolling(ts[ci_d[1:]], fp["low_level"], fp["n_levels"],
                                          fp["buy_volumes"], fp["sell_volumes"], 600.0,
                                          mesh, n_bins=5)
    out.update({f"profile.{i}": x for i, x in enumerate(prof)})
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v) for k, v in out.items()}


def layer_cases(mesh: TimeMesh, cols, spans=None, tick: float = TICK) -> dict:
    """:func:`product_cases` and :func:`footprint_cases`."""
    return {**product_cases(mesh, cols, spans, tick), **footprint_cases(mesh, cols, spans, tick)}


def single_products(cols, device, tick: float = TICK) -> dict:
    """:func:`product_cases` on one device with the single-device functions."""
    ts, price, amount, side = cols
    p = _params(cols)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    pt, at, st = T(price), T(amount), T(side)
    clock, ci = indexers.time_bar_indexer(T(ts), p["interval"])
    out = {}
    prod = aggregate.comp_bar_ohlcv(pt, at, ci)
    prod.update(aggregate.comp_bar_directional_features(pt, at, ci, st))
    out.update({f"products.{k}": v for k, v in prod.items()})
    theta = torch.full((ci.shape[0] - 1,), float(np.median(amount)), dtype=torch.float64,
                       device=device)
    out.update({f"trade_size.{k}": v for k, v in
                aggregate.comp_bar_trade_size_features(at, theta, ci, 5.0).items()})
    out["median"] = prod["median_trade_size"]
    ks = torch.from_numpy(_kth_ranks(ci.cpu().numpy())).to(device)
    srt = sorted_segments(at, *bar_ids_from_close_indices(ci, at.shape[0]), ci.shape[0] - 1)
    out["kth"] = srt[((ci[:-1] - ci[0])[None, :] + ks).clamp(0, at.shape[0] - 1)]
    close = prod["close"]
    out["ewma"] = ewma(close, 10, device=device)
    bars_ts = clock[1:ci.shape[0]]
    ev, tgt = _events(close, device)
    labels = triple_barrier(bars_ts, close, ev, tgt, (1.0, 1.0), 1800.0)
    out.update({f"labels.{i}": x for i, x in enumerate(labels)})
    w_u, conc = average_uniqueness(bars_ts, ev, labels[1])
    out["w_u"] = w_u
    out["w_r"] = return_attribution(ev, labels[1], close, conc)
    return {k: v.cpu().numpy() for k, v in out.items()}


def single_footprints(cols, device, tick: float = TICK) -> dict:
    """:func:`footprint_cases` on one device with the single-device functions."""
    ts, price, amount, side = cols
    p = _params(cols)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    pt, at, st = T(price), T(amount), T(side)
    _, ci_d = indexers.dollar_bar_indexer(T(ts), pt, at, p["dol"])
    dprod = aggregate.comp_bar_ohlcv(pt, at, ci_d)
    low, high = footprint.bar_levels(dprod["low"], dprod["high"], tick)
    fp = footprint.comp_bar_footprints(pt, at, ci_d, st, tick, dprod["low"], dprod["high"],
                                       3.0, max_levels=int((high - low + 1).max()))
    out = {"ci": ci_d}
    out.update({f"footprints.{k}": v for k, v in fp.items()})
    prof = volume_profile_rolling(T(ts)[ci_d[1:]], fp["low_level"], fp["n_levels"],
                                  fp["buy_volumes"], fp["sell_volumes"], 600.0, n_bins=5,
                                  device=device)
    out.update({f"profile.{i}": x for i, x in enumerate(prof)})
    return {k: v.cpu().numpy() for k, v in out.items()}


def single_layer(cols, device, tick: float = TICK) -> dict:
    """:func:`layer_cases` on one device with the single-device functions."""
    return {**single_products(cols, device, tick), **single_footprints(cols, device, tick)}


def on_worlds(mesh: TimeMesh, what: str, n: int, seed: int = 7, worlds=(1, 3, 4),
              dyadic: bool = False) -> dict:
    """Run :func:`indexer_cases`, :func:`product_cases`,
    :func:`footprint_cases` or :func:`layer_cases` (``what``: "indexers",
    "products", "footprints" or "layer") on
    :func:`synth_trades` ``(n, seed, dyadic)`` over groups of the mesh's first
    ``w`` ranks for each ``w`` of ``worlds`` (the 3-rank group on
    :func:`uneven_spans`): ``{w: cases}`` for the groups this rank is in."""
    cols = synth_trades(n, seed, dyadic)
    fn = {"indexers": indexer_cases, "products": product_cases,
          "footprints": footprint_cases, "layer": layer_cases}[what]
    extra = {"tick": DYADIC_TICK} if dyadic and what != "indexers" else {}
    out = {}
    for w in worlds:
        if w == mesh.size:
            sub = mesh
        else:   # every rank creates every group, in the same order
            g = dist.new_group(list(range(w)),
                               timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT))
            if mesh.rank >= w:
                continue
            sub = time_mesh(g, device=mesh.device)
        out[w] = fn(sub, cols, uneven_spans(n, w) if w == 3 else None, **extra)
    return out


def pin_streams(n: int = 4000):
    """The streams of the JAX package's sharded faults that the port does not
    copy: ``r21``, float32 volumes of one large trade and then ones (the
    prefix sums past it round to 16, so a search of them moves the volume
    bars' closes, ROADMAP D1; threshold 10); ``r20``, prices with a zero among
    them (returns of -inf and +inf, after which the JAX device form closes no
    CUSUM bar, R10; sigma 1e-3, floor 1e-9, mult 3); ``r19``, prices whose
    footprint levels at a tick of 1e-9 leave int32."""
    g = np.random.default_rng(19)
    ts = 1_700_000_000_000_000_000 + np.cumsum(g.integers(1, 10**8, n))
    vol = np.ones(n, np.float32)
    vol[0] = np.float32(1e17)
    px = np.round(100.0 * np.exp(np.cumsum(g.normal(0, 1e-3, n))), 2)
    px[n // 2] = 0.0
    side = np.where(g.random(n) < 0.5, 1, -1).astype(np.int8)
    return dict(ts=ts, vol=vol, px=px, side=side, sigma=np.full(n, 1e-3))


def pin_cases(mesh: TimeMesh) -> dict:
    """The port's sharded results on :func:`pin_streams`: the float volume
    bars (``r21``), the CUSUM bars (``r20``) and the message a footprint grid
    whose levels leave int32 raises (``r19``)."""
    p = pin_streams()
    ts, px = p["ts"], p["px"]
    out = {"r21": si.sharded_volume_bar_indexer(ts, p["vol"], 10.0, mesh)[1],
           "r20": si.sharded_cusum_bar_indexer(ts, px, p["sigma"], 1e-9, 3.0, mesh)[1]}
    out.update(footprint_pin(mesh))
    return out


def footprint_pin(mesh: TimeMesh) -> dict:
    """``{"r19": the message}`` of a footprint grid whose levels leave int32
    (:func:`pin_streams`)."""
    p = pin_streams()
    ts, px = p["ts"], p["px"]
    out = {}
    good = np.where(px > 0, px, 100.0)
    tr = shard_trades({"price": good, "amount": p["vol"], "side": p["side"]}, mesh)
    ci = np.array([-1, len(ts) // 2, len(ts) - 1])
    try:
        sharded_bar_footprints(tr, ci, np.array([50.0, 60.0]), np.array([150.0, 160.0]),
                               1e-9, 3.0, mesh)
        out["r19"] = ""
    except ValueError as e:
        out["r19"] = str(e)
    return out


def suite(mesh: TimeMesh, what: str, n: int, seed: int = 7) -> dict:
    """:func:`on_worlds` on the synthetic trades and on their dyadic form, and
    (for the indexers) :func:`pin_cases`: ``{"synth": ..., "dyadic": ...,
    "pins": ...}``, what one spawn of a parity test file computes."""
    out = {kind: on_worlds(mesh, what, n, seed, dyadic=kind == "dyadic")
           for kind in ("synth", "dyadic")}
    if what in ("indexers", "footprints"):
        out["pins"] = pin_cases(mesh) if what == "indexers" else footprint_pin(mesh)
    return out


def mesh_check(mesh: TimeMesh, how: str = "ok") -> dict:
    """A rank's view of the mesh for the mesh tests: its rank, size, backend
    and device, and the all-reduced, broadcast and gathered ranks. ``how``:
    ``"raise"`` (the last rank raises), ``"hang"`` (the last rank never
    enters the collective; the others wait in it), ``"grid"`` (a 2 x (size /
    2) ``symbol_time_mesh``, each row's sum of ranks)."""
    from .mesh import all_gather, all_reduce, broadcast, symbol_time_mesh
    last = mesh.rank == mesh.size - 1
    if how == "raise" and last:
        raise ValueError("this rank raises on purpose")
    if how == "hang" and last:
        time.sleep(3600)
    r = torch.tensor([float(mesh.rank)], dtype=torch.float64, device=mesh.device)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": mesh.device.type, "sum": float(all_reduce(mesh, r, "sum")),
           "max": float(all_reduce(mesh, r, "max")),
           "from_last": float(broadcast(mesh, r, mesh.size - 1)),
           "gathered": all_gather(mesh, r).flatten().tolist()}
    if how == "grid":
        grid = symbol_time_mesh(2, mesh.size // 2, device=mesh.device)
        out["symbol"] = grid.symbol
        out["row_sum"] = float(all_reduce(grid.time, r, "sum"))
        out["row_rank"] = grid.time.rank
    return out


def _compare(got: dict, want: dict, exact_floats: bool) -> list:
    """The cases of ``got`` that differ from ``want``: integers and every
    index bit for bit, floats bit for bit or (``exact_floats`` False) within
    1e-9 relative."""
    bad = []
    for k, w in want.items():
        g = got[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            bad.append(f"{k}: {g.dtype}{g.shape} != {w.dtype}{w.shape}")
        elif w.dtype.kind == "f" and not exact_floats:
            if not np.allclose(g, w, rtol=1e-9, atol=0.0, equal_nan=True):
                bad.append(k)
        elif not np.array_equal(g, w, equal_nan=w.dtype.kind == "f"):
            bad.append(k)
    return bad


def launch_counts() -> dict:
    """The kernel launch counters of the sharded layer's path, by kernel:
    E by scan (imbalance with its map path, run with its count search, and
    the count search apart), D, S (its float streams apart), C, F, R and G,
    read from the trace registry."""
    return {"E cusum": trace.counter("launch.E.cusum"),
            "E imbalance": (trace.counter("launch.E.imbalance")
                            + trace.counter("launch.E.imbalance_map")),
            "E run": trace.counter("launch.E.run") + trace.counter("launch.E.run_count"),
            "E run_count": trace.counter("launch.E.run_count"),
            "E volume": trace.counter("launch.E.volume"),
            "D": trace.counter("launch.D"), "S": trace.counter("launch.S"),
            "S float": trace.counter("launch.S.float"), "C": trace.counter("launch.C"),
            "F": trace.counter("launch.F.ffill"), "R": trace.counter("launch.R"),
            "G": trace.counter("launch.G")}


def _digest(x) -> str:
    import hashlib
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def month_path(mesh: TimeMesh, spec: dict) -> dict:
    """``chip_smoke.py`` phase 14 on a rank: the month of bench.py's draws
    (``testing.bench_trades``, ``spec["n"]`` trades, seed ``spec["seed"]``)
    through the sharded layer, each rank on its even span.

    The stages, each timed on every rank after a warm call (the device
    synchronized; the launches and bytes those of the timed calls): the
    indexers (time bars of ``spec["interval"]`` s, tick bars, volume bars in
    units (kernel E) and in float64 (kernel D), dollar bars in units and in
    float64, CUSUM bars, tick imbalance bars at a fixed theta, run bars at
    EMA thresholds), the time bars' products, trade-size features and
    medians, an EWMA of 20 on the closes, the triple barrier on the time bars
    sharded over CUSUM events with its weights, and the footprints of the
    dollar bars of the first ``spec["fp_days"]`` days with their rolling
    profile. ``spec["only"] == "indexers"`` stops after the indexers.

    Returns, on every rank, each output's digest, the launches, the stage
    seconds, each ring's seconds (this rank's scan, the ring's wall; the
    trace registry's ``ring.<indexer>`` spans, tracing on) and the bytes of the
    collectives; with ``spec["stage"]`` also the time indexer and the volume
    ring again with every collective staged through host memory, and whether
    they gave the same closes; rank 0 also holds every output against the
    single-device functions on its device after the timed stages (``bad``:
    what differs, ``single_seconds``: their times, each after a warm call)
    and returns the bar counts."""
    was_on = trace.enabled()
    trace.enable()      # the rings' scans wait for the card, so their spans time them
    try:
        return _month_path(mesh, spec)
    finally:
        if not was_on:
            trace.disable()


def _ring_ms() -> dict:
    return {k: v["host_ms"] for k, v in trace.report().items() if k.startswith("ring.")}


def _month_path(mesh: TimeMesh, spec: dict) -> dict:
    from ..bar.quantize import quantize_trades
    from ..testing import bench_trades, cusum_sigma, hold_float_path
    from . import mesh as pmesh
    dev = mesh.device
    n, sp = spec["n"], spec
    ts, price, amount, side = bench_trades(n, sp["seed"])
    q = quantize_trades(price, amount)
    sigma = cusum_sigma(n, sp["sigma"], sp["seed"])
    vol_thr = float(amount.astype(np.float64).sum()) / sp["volume_bars"]
    dol_thr = float((price * amount.astype(np.float64)).sum()) / sp["dollar_bars"]
    seconds, out, launches, moved, ring_ms = {}, {}, {}, {}, {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def stage(name, fn):
        """``fn()`` once warm (the allocator's blocks, the groups' first
        calls), then timed, its launches and collective bytes counted."""
        fn()
        sync()
        before, b0, r0 = launch_counts(), dict(pmesh.BYTES), _ring_ms()
        t0 = time.perf_counter()
        got = fn()
        sync()
        seconds[name] = time.perf_counter() - t0
        for k, v in _ring_ms().items():
            if v > r0.get(k, 0.0):
                ring_ms[k] = v - r0.get(k, 0.0)
        for k, v in launch_counts().items():
            launches[k] = launches.get(k, 0) + v - before[k]
        for k, v in pmesh.BYTES.items():
            moved[k] = moved.get(k, 0) + v - b0[k]
        return got

    qkw = dict(amount_units=q.amount_units, amount_scale=q.amount_scale)
    dkw = dict(price_ticks=q.price_ticks, amount_units=q.amount_units,
               tick_size=q.tick_size, amount_scale=q.amount_scale)
    indexer_calls = {
        "time": lambda: si.sharded_time_bar_indexer(ts, sp["interval"], mesh),
        "tick": lambda: si.sharded_tick_bar_indexer(ts, sp["ticks"], mesh),
        "volume_q": lambda: si.sharded_volume_bar_indexer(ts, None, vol_thr, mesh, **qkw),
        "volume": lambda: si.sharded_volume_bar_indexer(ts, amount, vol_thr, mesh),
        "dollar_q": lambda: si.sharded_dollar_bar_indexer(ts, None, None, dol_thr, mesh,
                                                          **dkw),
        "dollar": lambda: si.sharded_dollar_bar_indexer(ts, price, amount, dol_thr, mesh),
        "cusum": lambda: si.sharded_cusum_bar_indexer(ts, price, sigma, sp["floor"],
                                                      sp["mult"], mesh),
        "imbalance": lambda: si.sharded_imbalance_bar_indexer(ts, side, threshold=sp["theta"],
                                                              mesh=mesh),
        "run": lambda: si.sharded_run_bar_indexer(ts, side, mesh=mesh, **sp["run"]),
    }
    for name, call in indexer_calls.items():
        out[f"ci.{name}"] = stage(f"indexer {name}", call)[1]
    if sp.get("only") != "indexers":
        tr = stage("shard", lambda: shard_trades(
            {"ts": ts, "price": price, "amount": amount, "side": side}, mesh))
        ci = out["ci.time"]
        prod = stage("products", lambda: sharded_bar_products(tr, ci, mesh))
        out.update({f"products.{k}": v for k, v in prod.items()})
        theta = np.full(len(ci) - 1, float(np.median(amount)))
        out.update({f"trade_size.{k}": v for k, v in stage(
            "trade size", lambda: sharded_trade_size_features(tr, ci, theta, mesh)).items()})
        close = prod["close"]
        out["ewma"] = stage("ewma", lambda: ewma(close, 20, device=dev))
        bars_ts = torch.from_numpy(ts[ci[1:]]).to(dev)

        def labels_stage():
            ev, tgt = _events(close, dev)
            e0, e1 = mesh.span(ev.shape[0])
            lab = triple_barrier(bars_ts, close, ev[e0:e1], tgt[e0:e1], (1.0, 1.0),
                                 sp["barrier_s"])
            lab = [gather_ragged(mesh, x) for x in lab]
            w_u, conc = average_uniqueness(bars_ts, ev, lab[1])
            return lab + [w_u, return_attribution(ev, lab[1], close, conc)]
        for i, x in enumerate(stage("labels", labels_stage)):
            out[f"labels.{i}"] = x
        # the footprints of the first days' dollar bars
        m = int(np.searchsorted(ts, ts[0] + int(sp["fp_days"] * 86_400e9)))
        fts, fpx, famt, fside = ts[:m], price[:m], amount[:m], side[:m]
        ftr = shard_trades({"price": fpx, "amount": famt, "side": fside}, mesh)
        _, ci_d = stage("footprint bars", lambda: si.sharded_dollar_bar_indexer(
            fts, None, None, dol_thr, mesh, price_ticks=q.price_ticks[:m],
            amount_units=q.amount_units[:m], tick_size=q.tick_size,
            amount_scale=q.amount_scale))
        out["ci.footprints"] = ci_d
        dprod = sharded_bar_products(ftr, ci_d, mesh)
        fp = stage("footprints", lambda: sharded_bar_footprints(
            ftr, ci_d, dprod["low"], dprod["high"], q.tick_size, 3.0, mesh))
        out.update({f"footprints.{k}": v for k, v in fp.items()})
        prof = stage("profile", lambda: sharded_volume_profile_rolling(
            fts[ci_d[1:]], fp["low_level"], fp["n_levels"], fp["buy_volumes"],
            fp["sell_volumes"], sp["profile_window"], mesh, n_bins=27))
        out.update({f"profile.{i}": x for i, x in enumerate(prof)})
    ring = {k[5:]: (ring_ms.get(k + ".scan", 0.0) / 1e3, v / 1e3)
            for k, v in ring_ms.items() if not k.endswith(".scan")}
    out = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()}
    res = {"rank": mesh.rank, "digests": {k: _digest(v) for k, v in out.items()},
           "launches": launches, "seconds": seconds, "ring": ring, "bytes": moved,
           "footprint_trades": m if sp.get("only") != "indexers" else 0}
    if sp.get("stage") and mesh.backend == "gloo" and dev.type == "cuda":
        saved = set(pmesh.GLOO_CUDA_REFUSED)
        pmesh.GLOO_CUDA_REFUSED.update({"all_reduce", "broadcast", "all_gather"})
        try:
            again = {"ci.time": indexer_calls["time"]()[1],
                     "ci.volume_q": indexer_calls["volume_q"]()[1]}
        finally:
            pmesh.GLOO_CUDA_REFUSED.clear()
            pmesh.GLOO_CUDA_REFUSED.update(saved)
        res["staged_same"] = all(np.array_equal(v, out[k]) for k, v in again.items())
        res["staged_bytes"] = pmesh.BYTES["staged"]
    if mesh.rank == 0:
        res["counts"] = {k: int(v.shape[0]) - 1 for k, v in out.items() if k.startswith("ci.")}
        if sp.get("only") != "indexers":
            res["bad"], res["single_seconds"], res["shares"] = _hold_month(
                out, sp, (ts, price, amount, side), q, sigma, vol_thr, dol_thr, m, dev,
                hold_float_path)
            res["grid"] = list(out["footprints.buy_volumes"].shape)
    return res


def _hold_month(out, sp, cols, q, sigma, vol_thr, dol_thr, m, dev, hold_float_path):
    """Rank 0's holds of the month's sharded outputs against the
    single-device functions on its device: closes, integers, prices, medians,
    footprints, labels and weights bit for bit, float64 sums within
    ``hold_float_path``'s bounds, the profile's ``pct`` within rtol 1e-12.
    Returns ``(what differs, the single-device seconds, the float sums'
    largest shares of their bounds)``."""
    ts, price, amount, side = cols
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    tt, pt, at, st = T(ts), T(price), T(amount), T(side)
    seconds, want = {}, {}

    def timed(name, fn):
        fn()                                        # warm
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        seconds[name] = time.perf_counter() - t0
        return got

    units, ticks = T(q.amount_units), T(q.price_ticks)
    calls = {
        "time": lambda: indexers.time_bar_indexer(tt, sp["interval"]),
        "tick": lambda: indexers.tick_bar_indexer(tt, sp["ticks"]),
        "volume_q": lambda: indexers.volume_bar_indexer_q(tt, units, vol_thr, q.amount_scale),
        "volume": lambda: indexers.volume_bar_indexer(tt, at, vol_thr),
        "dollar_q": lambda: indexers.dollar_bar_indexer_q(tt, ticks, units, dol_thr,
                                                          q.tick_size, q.amount_scale),
        "dollar": lambda: indexers.dollar_bar_indexer(tt, pt, at, dol_thr),
        "cusum": lambda: indexers.cusum_bar_indexer(tt, pt, T(sigma), sp["floor"],
                                                    sp["mult"]),
        "imbalance": lambda: indexers.imbalance_bar_indexer(tt, st, threshold=sp["theta"]),
        "run": lambda: indexers.run_bar_indexer(tt, st, **sp["run"]),
    }
    for name, call in calls.items():
        want[f"ci.{name}"] = timed(f"indexer {name}", call)[1]
    ci = want["ci.time"]
    prod = timed("products", lambda: {**aggregate.comp_bar_ohlcv(pt, at, ci),
                                      **aggregate.comp_bar_directional_features(pt, at, ci,
                                                                                st)})
    want.update({f"products.{k}": v for k, v in prod.items()})
    theta = torch.full((ci.shape[0] - 1,), float(np.median(amount)), dtype=torch.float64,
                       device=dev)
    want.update({f"trade_size.{k}": v for k, v in timed(
        "trade size", lambda: aggregate.comp_bar_trade_size_features(at, theta, ci,
                                                                     5.0)).items()})
    close = prod["close"]
    want["ewma"] = ewma(close, 20, device=dev)
    bars_ts = tt[ci[1:]]
    ev, tgt = _events(close, dev)
    lab = list(triple_barrier(bars_ts, close, ev, tgt, (1.0, 1.0), sp["barrier_s"]))
    w_u, conc = average_uniqueness(bars_ts, ev, lab[1])
    for i, x in enumerate(lab + [w_u, return_attribution(ev, lab[1], close, conc)]):
        want[f"labels.{i}"] = x
    _, ci_d = indexers.dollar_bar_indexer_q(tt[:m], ticks[:m], units[:m], dol_thr,
                                            q.tick_size, q.amount_scale)
    want["ci.footprints"] = ci_d
    dprod = aggregate.comp_bar_ohlcv(pt[:m], at[:m], ci_d)
    low, high = footprint.bar_levels(dprod["low"], dprod["high"], q.tick_size)
    fp = timed("footprints", lambda: footprint.comp_bar_footprints(
        pt[:m], at[:m], ci_d, st[:m], q.tick_size, dprod["low"], dprod["high"], 3.0,
        max_levels=int((high - low + 1).max())))
    want.update({f"footprints.{k}": v for k, v in fp.items()})
    prof = timed("profile", lambda: volume_profile_rolling(
        tt[:m][ci_d[1:]], fp["low_level"], fp["n_levels"], fp["buy_volumes"],
        fp["sell_volumes"], sp["profile_window"], n_bins=27, device=dev))
    want.update({f"profile.{i}": x for i, x in enumerate(prof)})
    want = {k: v.cpu().numpy() for k, v in want.items()}
    bad = [k for k in want if k not in out or out[k].shape != want[k].shape
           or out[k].dtype != want[k].dtype]
    floats = {"products": {}, "trade_size": {}}
    for k, w in want.items():
        if k in bad:
            continue
        group, _, name = k.partition(".")
        if group in floats and w.dtype.kind == "f" and name not in (
                "open", "high", "low", "close", "median_trade_size", "max_spread"):
            floats[group][name] = out[k]
        elif k == "profile.3":
            if not np.allclose(out[k], w, rtol=1e-12, atol=0.0):
                bad.append(k)
        elif not np.array_equal(out[k], w, equal_nan=w.dtype.kind == "f"):
            bad.append(k)
    shares = {}
    for group, got in floats.items():
        try:
            shares.update(hold_float_path(got, {k.partition(".")[2]: v for k, v in want.items()
                                                if k.startswith(group + ".")},
                                          price, amount, want["products.volume"], group))
        except AssertionError as e:
            bad.append(f"{group}: {str(e)[:200]}")
    return bad, seconds, shares


def _dryrun_rank(mesh: TimeMesh, n: int, seed: int) -> dict:
    cols = synth_trades(n, seed)
    t0 = time.perf_counter()
    got = indexer_cases(mesh, cols)
    got_l = layer_cases(mesh, cols)
    seconds = time.perf_counter() - t0
    want, want_l = single_indexers(cols, mesh.device), single_layer(cols, mesh.device)
    return {"bad": _compare(got, want, True) + _compare(got_l, want_l, False),
            "bars": {k: len(v) - 1 for k, v in got.items()},
            "events": int(got_l["labels.0"].shape[0]), "seconds": seconds}


def _ingest_rank(mesh: TimeMesh, path: str, months) -> dict:
    from .ingest import load_store_to_mesh
    from ..data.store import load_trades_h5
    tr, total, local = load_store_to_mesh(path, mesh, months=months, max_workers=2)
    whole = load_trades_h5(path).data
    ts = whole["timestamp"]
    p = _params((ts, whole["price"], whole["amount"], whole["side"]))
    clock, ci = si.sharded_time_bar_indexer(local["timestamp"], p["interval"], mesh,
                                            offset=tr.lo)
    prod = sharded_bar_products(tr, ci, mesh)
    one = aggregate.comp_bar_ohlcv(*(torch.from_numpy(np.ascontiguousarray(whole[k])).to(
        mesh.device) for k in ("price", "amount")), indexers.time_bar_indexer(
            torch.from_numpy(ts).to(mesh.device), p["interval"])[1])
    bad = [k for k in ("open", "high", "low", "close", "trades", "median_trade_size")
           if not np.array_equal(prod[k].cpu().numpy(), one[k].cpu().numpy())]
    return {"rows": int(tr.hi - tr.lo), "total": total, "bars": len(ci) - 1, "bad": bad}


def _write_store(path: str, n_month: int, seed: int):
    """Three months of :func:`synth_trades` in the store's layout."""
    from ..bar.data_model import TradesData
    from ..data.store import month_bounds, save_trades_h5
    months = ("2024-01", "2024-02", "2024-03")
    for k, key in enumerate(months):
        ts, price, amount, side = synth_trades(n_month, seed + k)
        start, end = month_bounds(key)
        ts = start + (ts - ts[0]) % (end - start - 1)
        ts.sort()
        td = TradesData(ts, price, amount, side=side, preprocess=False)
        save_trades_h5(td, path, month_key=key)
    return months


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="gloo", help="gloo, or nccl for one rank a card")
    ap.add_argument("--trades", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ingest", action="store_true",
                    help="the store flow of examples/multihost_ingest.py (needs h5py)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.ingest:
        try:
            import h5py  # noqa: F401
        except ImportError:
            print("dryrun --ingest needs h5py, which does not import here")
            return 1
        with tempfile.TemporaryDirectory(prefix="fmk_ingest_") as tmp:
            path = f"{tmp}/trades.h5"
            months = _write_store(path, args.trades, args.seed)
            res = spawn_mesh(_ingest_rank, args.ranks, args=(path, months),
                             backend=args.backend, device=args.device)
        bad = sorted({b for r in res for b in r["bad"]})
        print(f"dryrun ingest: {args.ranks} ranks, rows {[r['rows'] for r in res]} of "
              f"{res[0]['total']}, {res[0]['bars']} bars"
              + (f"; DIFFER: {bad}" if bad else ", products == one device"))
        return 1 if bad else 0
    res = spawn_mesh(_dryrun_rank, args.ranks, args=(args.trades, args.seed),
                     backend=args.backend, device=args.device)
    bad = sorted({b for r in res for b in r["bad"]})
    if bad:
        print(f"dryrun: {args.ranks} ranks differ from one device in {bad}")
        return 1
    print(f"dryrun ok: {args.ranks} ranks on {args.device} ({args.backend}), "
          f"{args.trades} trades, bars {res[0]['bars']}, {res[0]['events']} events, "
          f"rank seconds {[round(r['seconds'], 2) for r in res]}, "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
