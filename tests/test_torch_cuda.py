"""Kernels B, S, C, F, E, H, V, P, R, W, G and D on the card against their
plain versions, kernel Z (the CUSUM filter) against the host loop, the chain of ``chip_smoke.py`` phase 11 (trades to final
weights) through the kernels against its plain path, the float64 path of
trades on no tick grid (kernels D, S and C) through the kits, and the host-only
layers of phase 13: the 1-second klines (B, S) and their resample (S), the
host medians on card tensors, and the store where h5py imports.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip. The card's
host has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features
from finmlkit_tpu_torch.bar.footprint_q import comp_bar_footprints_q
from finmlkit_tpu_torch.bar.fused import median_engine, median_pairs, planes_products
from finmlkit_tpu_torch.bar.indexers import dollar_bar_indexer_q
from finmlkit_tpu_torch.feature.kernels import structural_break, volume
from finmlkit_tpu_torch.ops import (event_scan, float_walk, fused_scan, prefix_scan, scan,
                                   segment_hist)
from finmlkit_tpu_torch.testing import (CSW_FILTER_CASES, CUSUM_BAD, FLOAT_WALK_CASES,
                                       PROFILE_CASES, bench_trades,
                                       PROFILE_EXTRA_CASES,
                                       PROFILE_ROW_CASES, PROFILE_TS, PROFILE_WINDOW,
                                       TILE_CLOSES, adversarial_trades, assert_close,
                                       assert_exact, assert_window_close, assert_within,
                                       cusum_bad_inputs, float_walk_case, hold_float_path,
                                       csw_filter_case, cusum_recurrence, offgrid_trades,
                                       profile_case,
                                       profile_rows_case, tile_closes, zeros_and_twos)
from finmlkit_tpu_torch.sampling.filters import cusum_filter
from finmlkit_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


# the one-pass tiles hold 4096 int32 or 2048 int64 values, the float tiles 2048
SCAN_NS = [1, 2047, 2048, 2049, 4095, 4096, 4097, 2048 * 37 - 1, 2048 * 37 + 1,
           5_000_001, 39_171_930]


def _scan_input(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype.is_floating_point:
        return torch.rand(shape, dtype=dtype, device=device, generator=g)
    x = torch.randint(-1000, 1000, shape, dtype=dtype, device=device, generator=g)
    x.view(-1)[::3] = torch.iinfo(dtype).max // 2 + 1000  # near 2^31 or 2^63: wraps
    return x


def _check_scan(got, want, again):
    """Integers exactly the plain version's; floats within rtol of it and
    equal to themselves, bit for bit, over five more runs."""
    if got.dtype.is_floating_point:
        assert_close(got, want, rtol=1e-5 if got.dtype == torch.float32 else 1e-12)
        for _ in range(5):
            assert_exact(again(), got, "float scan run to run")
    else:
        assert_exact(got, want)


@pytest.mark.parametrize("n", SCAN_NS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64])
def test_scan_matches_plain(cuda, dtype, n):
    x = _scan_input((n,), dtype, cuda, n)
    before = (trace.counter("launch.S"), trace.counter("launch.S.float"))
    got = prefix_scan.fast_cumsum(x)
    assert (trace.counter("launch.S"), trace.counter("launch.S.float")) == \
        (before[0] + 1, before[1] + dtype.is_floating_point)
    _check_scan(got, prefix_scan.fast_cumsum_plain(x),
                lambda: prefix_scan.fast_cumsum(x))


@pytest.mark.parametrize("case", [
    dict(n=300_000, seed=1, first=-1, long_bar=100_000),
    dict(n=50_000, seed=2, first=9, mean_bar=3),
    dict(n=7, seed=3, first=-1, mean_bar=2),
])
def test_bar_products_and_medians_match_plain(cuda, case):
    arrs = adversarial_trades(**case)
    ticks, units, sides, amounts, ci = (torch.from_numpy(a).to(cuda) for a in arrs)
    before = trace.counter("launch.B")
    got = fused_scan.bar_scan_products(ticks, units, sides, ci)
    assert trace.counter("launch.B") == before + 1
    want = fused_scan.bar_scan_products_plain(ticks, units, sides, ci)
    for a, b in zip(got, want):
        assert_exact(a, b)
    for a, b in zip(median_pairs(amounts, ci),
                    median_pairs(amounts, ci, cumsum=prefix_scan.fast_cumsum_plain)):
        assert_exact(a, b)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("name", TILE_CLOSES)
def test_bar_products_tile_cases_match_plain(cuda, name, offset):
    # streams a few of kernel B's tiles long, with bars at the tiles' edges;
    # at an offset of one trade the inputs are not 16-byte aligned and the
    # kernel loads them one by one
    tile = fused_scan._TILE
    n = 5 * tile + 13
    ticks, units, sides, _, _ = (torch.from_numpy(a).to(cuda)[offset:]
                                 for a in adversarial_trades(n=n + offset, seed=41))
    ci = torch.from_numpy(tile_closes(name, n, tile)).to(cuda)
    before = trace.counter("launch.B")
    got = fused_scan.bar_scan_products(ticks, units, sides, ci)
    assert trace.counter("launch.B") == before + 1
    for what, a, b in zip(("p64", "p32", "pf"), got,
                          fused_scan.bar_scan_products_plain(ticks, units, sides, ci)):
        assert_exact(a, b, f"{name} {what}")


def test_bar_products_reject_unsorted_ci(cuda):
    arrs = adversarial_trades(n=1000, seed=4)
    ticks, units, sides, _, ci = (torch.from_numpy(a).to(cuda) for a in arrs)
    with pytest.raises(ValueError):
        fused_scan.bar_scan_products(ticks, units, sides, ci.flip(0))


@pytest.mark.parametrize("c,n", [(c, n) for c in (1, 2, 5)
                                 for n in (1, 2047, 2048, 2049, 4097, 5_000_001)]
                         + [(65_535, 5), (65_535, 4097)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64])
def test_cols_scan_matches_plain(cuda, dtype, c, n):
    x = _scan_input((c, n), dtype, cuda, n + c)
    before = trace.counter("launch.C")
    got = prefix_scan.fast_cumsum_cols(x)
    assert trace.counter("launch.C") == before + 1
    _check_scan(got, prefix_scan.fast_cumsum_cols_plain(x),
                lambda: prefix_scan.fast_cumsum_cols(x))


@pytest.mark.parametrize("case", [
    dict(n=300_000, seed=5, first=0, mean_bar=800),
    dict(n=50_000, seed=6, first=-1, mean_bar=3),
])
def test_order_flow_matches_plain(cuda, case):
    ticks, units, sides, amounts, ci = (
        torch.from_numpy(a).to(cuda) for a in adversarial_trades(**case))
    ts = torch.arange(len(ticks), device=cuda)
    small = units.clamp(max=10**8)  # keeps the dollar prefix inside int64
    before = trace.counter("launch.S")
    _, dci = dollar_bar_indexer_q(ts, ticks, small, 5e4, 0.1, 1e-8)
    assert trace.counter("launch.S") == before + 1
    _, dci_plain = dollar_bar_indexer_q(ts, ticks, small, 5e4, 0.1, 1e-8,
                                        cumsum=prefix_scan.fast_cumsum_plain)
    assert_exact(dci, dci_plain)
    assert len(dci) > 100
    p32 = fused_scan.bar_scan_products_plain(ticks, units, sides, ci)[1]
    low, high = p32[2].clone(), p32[1].clone()
    empty = ci[1:] == ci[:-1]
    low[empty], high[empty] = p32[3][empty], p32[3][empty]
    L = 8
    while L < int((high - low + 1).max()):
        L *= 2
    before = trace.counter("launch.C")
    got = comp_bar_footprints_q(ticks, amounts, ci, sides, low, high, 3.0,
                                max_levels=L)
    assert trace.counter("launch.C") == before + 1
    want = comp_bar_footprints_q(ticks, amounts, ci, sides, low, high, 3.0,
                                 max_levels=L,
                                 cumsum_cols=prefix_scan.fast_cumsum_cols_plain)
    for k in want:
        assert_exact(got[k], want[k], k)
    theta = amounts[:len(ci) - 1].double()
    got = bar_trade_size_features(units, amounts, ci, theta, amount_scale=1e-8)
    want = bar_trade_size_features(units, amounts, ci, theta, amount_scale=1e-8,
                                   cumsum=prefix_scan.fast_cumsum_plain,
                                   cumsum_cols=prefix_scan.fast_cumsum_cols_plain)
    for k in want:
        assert_exact(got[k], want[k], k)


def _ffill_case(n, dtype, mask, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn(n, dtype=dtype, device=device, generator=g)
    v[::7] = float("nan")
    if mask == "random":
        m = torch.rand(n, device=device, generator=g) < 0.3
    elif mask == "leading_invalid":
        m = torch.rand(n, device=device, generator=g) < 0.3
        m[:min(n, 5000)] = False
    else:
        m = torch.full((n,), mask == "all_valid", device=device)
    return v, m


def _bits(t):
    """A fill's bits: a selection keeps each NaN payload."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int64)


# kernel F's tiles hold 4096 values; past 32 x 64 tiles a look-back over
# tiles without a valid value takes many rounds of 32
FFILL_NS = [1, 2047, 2048, 2049, 4095, 4096, 4097, 8193, 5_000_001,
            4096 * 32 * 64 + 4097]


@pytest.mark.parametrize("n", FFILL_NS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mask", ["random", "leading_invalid", "all_valid",
                                  "none_valid"])
def test_ffill_matches_plain(cuda, dtype, n, mask):
    v, m = _ffill_case(n, dtype, mask, cuda, n)
    before = trace.counter("launch.F.ffill")
    got = prefix_scan.fast_ffill(v, m)
    assert trace.counter("launch.F.ffill") == before + 1
    assert_exact(_bits(got), _bits(prefix_scan.fast_ffill_plain(v, m)))
    if n > 1:   # a view that starts off 16-byte alignment takes the scalar path
        assert_exact(_bits(prefix_scan.fast_ffill(v[1:], m[1:])),
                     _bits(prefix_scan.fast_ffill_plain(v[1:], m[1:])), "offset by one")


# kernel E's chunk counts held against its default: the sequential walk, a
# few long chunks, many short ones (a 1M-trade stream has 489 tiles)
CHUNKS = (1, 7, 200)


def _sides(n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    s = torch.where(torch.rand(n, device=device, generator=g) < 0.5, 1, -1)
    return s.to(torch.float64), g


@pytest.mark.parametrize("run_mode", [False, True], ids=["imbalance", "run"])
@pytest.mark.parametrize("case", ["tick_fixed", "tick_ema", "volume_fixed",
                                  "capped", "every_trade"])
def test_info_scan_matches_plain(cuda, case, run_mode):
    n = 1_000_003
    w, g = _sides(n, cuda, 11)
    args = (1.0, 30.0, 0.0, 0.0)
    if case == "tick_ema":
        args = (1000.0, 0.5 if run_mode else 0.03, 0.05, 0.05)
    elif case == "volume_fixed":
        w = w * torch.rand(n, dtype=torch.float64, device=cuda, generator=g)
        args = (1.0, 7.5, 0.0, 0.0)
    elif case == "every_trade":
        n = 100_000
        w, args = w[:n], (1.0, 1.0, 0.0, 0.0)
    mb = 50 if case == "capped" else n
    before = (trace.counter("launch.E"), trace.counter("launch.S"))
    got = event_scan.info_scan(w, *args, mb, run_mode)
    assert (trace.counter("launch.E"), trace.counter("launch.S")) == \
        (before[0] + 1, before[1] + 1)   # E, and S for its compaction
    want = event_scan.info_scan_plain(w, *args, mb, run_mode)
    assert_exact(got, want)
    assert len(want) > 25
    e_t, e_r, a_t, a_r = args
    for chunks in CHUNKS:
        assert_exact(event_scan._launch(
            event_scan._RUN if run_mode else event_scan._IMBALANCE, n, 1, mb,
            cuda, x=w, e_t=e_t, e_r=e_r, alpha_t=a_t, alpha_r=a_r,
            chunks=chunks), got, f"{chunks} chunks against the default")


@pytest.mark.parametrize("thr", [1, 10**7, 10**9, 10**12])
def test_volume_scan_matches_plain(cuda, thr):
    n = 1_000_003
    g = torch.Generator(device=cuda).manual_seed(thr % 1000)
    units = torch.randint(0, 10**7, (n,), dtype=torch.int64, device=cuda,
                          generator=g)
    units[::50] = 10**9
    mb = n if thr > 1 else 200_000      # thr 1: a bar per trade, capped
    before = (trace.counter("launch.E"), trace.counter("launch.S"))
    got = event_scan.volume_scan(units, thr, mb)
    assert (trace.counter("launch.E"), trace.counter("launch.S")) == \
        (before[0] + 1, before[1] + 1)
    assert_exact(got, event_scan.volume_scan_plain(units, thr, mb))
    for chunks in CHUNKS:
        assert_exact(event_scan._launch(event_scan._VOLUME, n, 1, mb, cuda,
                                        units=units, thr=thr, chunks=chunks),
                     got, f"{chunks} chunks against the default")


@pytest.mark.parametrize("start", [0, 4097])
@pytest.mark.parametrize("max_bars", [None, 30])
def test_cusum_scan_matches_plain(cuda, start, max_bars):
    n = 1_000_003
    g = torch.Generator(device=cuda).manual_seed(start)
    rets = torch.randn(n, dtype=torch.float64, device=cuda, generator=g) * 2e-5
    rets[0] = 0.0
    rets[300_000:300_500] = 1e-3        # a burst: many closes in one tile
    lam = 1.2e-3 * (0.5 + torch.rand(n, dtype=torch.float64, device=cuda,
                                     generator=g))
    can_close = torch.rand(n, device=cuda, generator=g) < 0.9
    mb = n if max_bars is None else max_bars
    before = (trace.counter("launch.E"), trace.counter("launch.S"))
    got = event_scan.cusum_scan(rets, lam, can_close, start, mb)
    assert (trace.counter("launch.E"), trace.counter("launch.S")) == \
        (before[0] + 1, before[1] + 1)
    want = event_scan.cusum_scan_plain(rets, lam, can_close, start, mb)
    assert_exact(got, want)
    assert len(want) > 25
    for chunks in CHUNKS:
        assert_exact(event_scan._launch(event_scan._CUSUM, n, start + 1, mb,
                                        cuda, x=rets, lam=lam,
                                        can_close=can_close, chunks=chunks),
                     got, f"{chunks} chunks against the default")


# the map path's cases: (n, theta, weights); every one takes the map path
MAP_CASES = {
    "tick_theta30": (1_000_003, 30.0, "sides"),
    "theta_30_5": (300_001, 30.5, "sides"),
    "theta_1": (100_000, 1.0, "ints"),      # K = 0: every nonzero weight closes
    "theta_0_5": (100_000, 0.5, "ints"),
    "zeros_and_big": (500_000, 12.0, "big"),  # w = 0 trades, |w| up to 2^60
    "below_a_tile": (1_000, 8.0, "ints"),
    "ragged": (2048 * 300 + 17, 63.5, "ints"),  # 127 states, the cap
}


@pytest.mark.parametrize("case", list(MAP_CASES))
def test_info_scan_map_path_matches_plain(cuda, case):
    """Imbalance at a fixed theta on integer weights takes kernel E's map
    path, gives the plain scan's closes (capped too), and the walk gives
    them at every chunk count."""
    n, theta, kind = MAP_CASES[case]
    w, g = _sides(n, cuda, 13)
    if kind != "sides":
        w = torch.randint(-3, 4, (n,), device=cuda, generator=g).to(torch.float64)
    if kind == "big":
        w[::97] = 2.0 ** 60
        w[::89] = -1e15
        w[torch.rand(n, device=cuda, generator=g) < 0.3] = 0.0
    for mb in (n, 5):
        before = event_scan.mode_launches()
        got = event_scan.info_scan(w, 1.0, theta, 0.0, 0.0, mb, False)
        assert trace.counter("launch.E.imbalance_map") == \
            before[event_scan._IMBALANCE_MAP] + 1
        want = event_scan.info_scan_plain(w, 1.0, theta, 0.0, 0.0, mb, False)
        assert_exact(got, want, f"{case} max_bars={mb}")
        assert len(want) >= min(mb, 3)
        for mode in (event_scan._IMBALANCE_MAP, event_scan._IMBALANCE):
            for chunks in CHUNKS:
                assert_exact(event_scan._launch(mode, n, 1, mb, cuda, x=w, e_t=1.0,
                                                e_r=theta, chunks=chunks),
                             got, f"mode {mode}, {chunks} chunks")


@pytest.mark.parametrize("case", ["float_weights", "alpha", "theta_above_cap"])
def test_info_scan_takes_the_walk(cuda, case):
    n = 100_000
    w, g = _sides(n, cuda, 17)
    args = (1.0, 30.0, 0.0, 0.0)
    if case == "float_weights":
        w = w * 1.5
    elif case == "alpha":
        args = (1000.0, 0.03, 0.05, 0.0)
    else:
        args = (1.0, 64.5, 0.0, 0.0)         # 129 states
    before = event_scan.mode_launches()
    got = event_scan.info_scan(w, *args, n, False)
    assert [a - b for a, b in zip(event_scan.mode_launches(), before)] == [0, 1, 0, 0, 0, 0]
    assert_exact(got, event_scan.info_scan_plain(w, *args, n, False))


@pytest.mark.parametrize("run_mode", [False, True], ids=["imbalance", "run"])
@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
def test_info_scan_nonfinite_weight_matches_plain(cuda, bad, run_mode):
    """An imbalance bar's NaN weight leaves its sum NaN, which never closes
    (a run bar's adds nothing); an infinite weight closes and, at alpha 0,
    makes theta NaN: no close after it either."""
    n = 3000
    w = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, n)).to(cuda)
    w[1000] = float(bad)
    args = (1.0, 20.0 if run_mode else 8.0, 0.0, 0.0, n, run_mode)
    got = event_scan.info_scan(w, *args)
    want = event_scan.info_scan_plain(w, *args)
    assert_exact(got, want, bad)
    stops = bad != "nan" or not run_mode
    assert len(want) >= 5 and (int(want[-1]) <= 1000) == stops


@pytest.mark.parametrize("name", CUSUM_BAD)
def test_cusum_scan_nonfinite_matches_plain(cuda, name):
    """Kernel E's CUSUM mode on non-finite returns and thresholds
    (``testing.cusum_bad_inputs``, sums exact) against the plain scan, at the
    default chunk count, 528 and ``CHUNKS``: the IEEE recurrence of the
    reference's host loop, held there to its numpy transcription."""
    n = 300_000
    rets, lam, cc = (torch.from_numpy(a).to(cuda)
                     for a in cusum_bad_inputs(name, n, 150_000)[:3])
    want = event_scan.cusum_scan_plain(rets, lam, cc, 0, n)
    assert_exact(want, cusum_recurrence(rets, lam, cc, 0), "plain against the recurrence")
    assert_exact(event_scan.cusum_scan(rets, lam, cc, 0, n), want, "default chunks")
    for chunks in (528, *CHUNKS):
        assert_exact(event_scan._launch(event_scan._CUSUM, n, 1, n, cuda, x=rets, lam=lam,
                                        can_close=cc, chunks=chunks),
                     want, f"{chunks} chunks")
    assert len(want) > 100


# kernel E's count search (mode 5) on int8 sides: the month's length at the
# event cell's EMA, two other thresholds, sides with zeros, bars of more than
# a 1024-trade block: (n, (e_t, e_r, alpha_t, alpha_r), share of zeros)
RUN_COUNT_CASES = {
    "month_ema": (39_171_929, (1000.0, 0.5, 0.05, 0.05), 0.0),
    "fixed_30_zeros": (2_000_003, (1.0, 30.0, 0.0, 0.0), 0.3),
    "ema_fast": (4_000_037, (100.0, 0.6, 0.2, 0.1), 0.0),
    "above_a_block": (3_000_001, (1.0, 6000.5, 0.0, 0.0), 0.1),
}


def _int8_sides(n, zeros, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    s = torch.where(torch.rand(n, device=device, generator=g) < 0.5, 1, -1).to(torch.int8)
    if zeros:
        s[torch.rand(n, device=device, generator=g) < zeros] = 0
    return s


def _mode_delta(before):
    return [a - b for a, b in zip(event_scan.mode_launches(), before)]


@pytest.mark.parametrize("case", list(RUN_COUNT_CASES))
def test_run_count_matches_the_walk_and_plain(cuda, case):
    """Tick run bars take the count search, once a call, and give the walk's
    closes and exit state and the plain scan's closes bit for bit; cut to 50
    closes, the count is capped and the exit state is still the stream's."""
    n, args, zeros = RUN_COUNT_CASES[case]
    w = _int8_sides(n, zeros, cuda, 29).to(torch.float64)
    kw = dict(zip(("e_t", "e_r", "alpha_t", "alpha_r"), args))
    before = event_scan.mode_launches()
    got, end = event_scan.info_scan(w, *args, n, True, integral=True, exit_state=True)
    assert _mode_delta(before) == [0, 0, 0, 0, 0, 1]
    walk, walk_end = event_scan._launch(event_scan._RUN, n, 1, n, cuda, x=w,
                                        exit_state=True, **kw)
    assert_exact(got, walk, f"{case}: the walk forced")
    assert same_state(end, walk_end), (end, walk_end)
    want = event_scan.info_scan_plain(w, *args, n, True)
    assert_exact(got, want, f"{case}: plain")
    assert len(want) > 100
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    cut, cut_end = event_scan._launch(event_scan._RUN_COUNT, n, 1, 50, cuda, x=w,
                                      stats=stats, exit_state=True, **kw)
    assert_exact(cut, want[:50], f"{case}: 50 closes")
    assert same_state(cut_end, walk_end), (cut_end, walk_end)
    requested, misses, _, ns = stats.tolist()
    assert requested >= 8 and ns > 0 and (misses > 0) == (case == "above_a_block")


def test_run_count_from_entry_states_matches_plain(cuda):
    """The count search from whole entry sums, trade 0 checked, against the
    plain scan from the same state: closes and exit state."""
    n = 1_000_003
    w = _int8_sides(n, 0.1, cuda, 37).to(torch.float64)
    for entry in ((29.0, 3.0, 1.0, 30.0, -7), (45.0, 2.0, 1.0, 30.0, -3),
                  (480.0, 399.0, 1000.0, 0.5, -12_345), (-900.0, 0.0, 1.0, 30.0, -5)):
        args = (entry[2], entry[3], 0.05 if entry[2] > 1 else 0.0,
                0.05 if entry[2] > 1 else 0.0)
        before = event_scan.mode_launches()
        got, end = event_scan.info_scan(w, *args, n, True, integral=True, state=entry,
                                        first_closes=True, exit_state=True)
        assert _mode_delta(before) == [0, 0, 0, 0, 0, 1]
        want, want_end = event_scan.info_scan_plain(w, *args, n, True, state=entry,
                                                    first_closes=True, exit_state=True)
        assert_exact(got, want, str(entry))
        assert same_state(end, want_end), (entry, end, want_end)


def test_run_count_flag_walks_again(cuda):
    """A side of 2 sets the pack's flag: the search returns nothing, the scan
    walks (one more launch.E.run) and equals the plain scan."""
    from finmlkit_tpu_torch.bar.indexers import run_bar_indexer
    n = 1_000_003
    s = _int8_sides(n, 0.1, cuda, 31)
    s[n // 2] = 2
    w = s.to(torch.float64)
    assert event_scan._launch(event_scan._RUN_COUNT, n, 1, n, cuda, x=w, e_t=1.0,
                              e_r=30.0) is None
    before = event_scan.mode_launches()
    got = event_scan.info_scan(w, 1.0, 30.0, 0.0, 0.0, n, True, integral=True)
    assert _mode_delta(before) == [0, 0, 1, 0, 0, 1]
    assert_exact(got, event_scan.info_scan_plain(w, 1.0, 30.0, 0.0, 0.0, n, True))
    ts = torch.arange(n, dtype=torch.int64, device=cuda)
    ema = dict(expected_ticks_init=1000.0, expected_rate_init=0.5, alpha_ticks=0.05,
               alpha_rate=0.05)
    assert_exact(run_bar_indexer(ts, s, **ema)[1],
                 run_bar_indexer(ts, s, **ema, scan=event_scan.info_scan_plain)[1])


@pytest.mark.parametrize("case", ["float_weights", "not_integral", "fractional_entry"])
def test_run_bars_off_the_route_take_the_walk(cuda, case):
    """Volume run bars (float weights), a caller that does not say the
    weights are integers, and a fractional entry sum: the walk, mode 2."""
    from finmlkit_tpu_torch.bar.indexers import run_bar_indexer
    n = 500_003
    s = _int8_sides(n, 0.0, cuda, 41)
    ema = dict(expected_ticks_init=100.0, expected_rate_init=0.6, alpha_ticks=0.05,
               alpha_rate=0.05)
    args = (100.0, 0.6, 0.05, 0.05)
    before = event_scan.mode_launches()
    if case == "float_weights":
        ts = torch.arange(n, dtype=torch.int64, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(43)
        amounts = torch.rand(n, dtype=torch.float64, device=cuda, generator=g)
        got = run_bar_indexer(ts, s, amounts, **ema)[1]
        want = run_bar_indexer(ts, s, amounts, **ema, scan=event_scan.info_scan_plain)[1]
    else:
        w = s.to(torch.float64)
        state = (0.5 if case == "fractional_entry" else 0.0, 0.0, *args[:2], 0)
        got = event_scan.info_scan(w, *args, n, True, state=state,
                                   integral=case == "fractional_entry")
        want = event_scan.info_scan_plain(w, *args, n, True, state=state)
    assert _mode_delta(before) == [0, 0, 1, 0, 0, 0]
    assert_exact(got, want, case)
    assert len(want) > 10


def test_run_count_spans_chain_as_one_scan(cuda):
    """The month's run bars cut into four spans, each scanned from the state
    the one before left with trade 0 checked (as the sharded ring scans its
    shards): each span takes the count search, and the spans' closes and exit
    state are one scan's."""
    n = 39_171_929
    w = _int8_sides(n, 0.0, cuda, 47).to(torch.float64)
    args = (1000.0, 0.5, 0.05, 0.05)
    whole, whole_end = event_scan.info_scan(w, *args, n, True, integral=True,
                                            exit_state=True)
    cuts = [0, 2, n // 4, n // 2 + 777, n]
    parts, state = [], None
    for a, b in zip(cuts, cuts[1:]):
        st = None if state is None else state[:4] + (state[4] - a,)
        before = event_scan.mode_launches()
        got, end = event_scan.info_scan(w[a:b], *args, n, True, integral=True, state=st,
                                        first_closes=a > 0, exit_state=True)
        assert _mode_delta(before) == [0, 0, 0, 0, 0, 1]
        parts.append(got + a)
        state = end[:4] + (end[4] + a,)
    assert_exact(torch.cat(parts), whole, "four spans")
    assert same_state(state, whole_end), (state, whole_end)


def test_event_scan_edges(cuda):
    w = torch.ones(1, dtype=torch.float64, device=cuda)
    assert event_scan.info_scan(w, 1.0, 1.0, 0.0, 0.0, 10, False).numel() == 0
    u = torch.tensor([5, 1, 1, 7], dtype=torch.int64, device=cuda)
    assert event_scan.volume_scan(u, 3, 10).tolist() == [1, 3]
    assert event_scan.volume_scan(u, 3, 0).numel() == 0


ENGINE_CASES = [dict(n=300_000, seed=21, first=-1, long_bar=100_000),
                dict(n=50_000, seed=22, first=9, mean_bar=3),
                dict(n=7, seed=23, first=-1, mean_bar=2)]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_hist_passes_match_plain(cuda, case):
    ticks, units, sides, amounts, ci = (
        torch.from_numpy(a).to(cuda) for a in adversarial_trades(**case))
    bits = amounts.view(torch.int32)
    g = torch.Generator(device=cuda).manual_seed(case["seed"])
    base = (bits[(ci[:-1] + 1).clamp(0, len(bits) - 1)]
            - torch.randint(0, 1 << 20, (len(ci) - 1,), device=cuda, generator=g,
                            dtype=torch.int32))
    for s in segment_hist.SHIFTS:
        before = trace.counter("launch.H")
        got = segment_hist.hist_pass(bits, ci, base, s)
        assert trace.counter("launch.H") == before + 1
        assert_exact(got, segment_hist.hist_pass_plain(bits, ci, base, s), f"s={s}")
    for got, want in zip(segment_hist.less_pass(bits, ci, base),
                         segment_hist.less_pass_plain(bits, ci, base)):
        assert_exact(got, want, "less")


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("tile", [16, 4096])
@pytest.mark.parametrize("name", TILE_CLOSES + ("one_trade_bars",))
def test_hist_tile_cases_match_plain(cuda, name, tile, offset):
    """Kernel H's tiles (4096 trades) and threads (16) against closes on
    their edges, bits aligned to 16 bytes and not."""
    n = 6 * 4096 + 77
    amounts = torch.from_numpy(adversarial_trades(n + offset, seed=31)[3]).to(cuda)
    bits = amounts.view(torch.int32)[offset:]
    if name == "one_trade_bars":
        ci = torch.arange(-1, n - 3, device=cuda)
    else:
        ci = torch.from_numpy(tile_closes(name, n, tile)).to(cuda)
    base = bits[(ci[:-1] + 1).clamp(0, n - 1)] - 12345
    for s in segment_hist.SHIFTS:
        assert_exact(segment_hist.hist_pass(bits, ci, base, s),
                     segment_hist.hist_pass_plain(bits, ci, base, s), f"s={s}")
    for got, want in zip(segment_hist.less_pass(bits, ci, base + 99),
                         segment_hist.less_pass_plain(bits, ci, base + 99)):
        assert_exact(got, want, "less")
    # at s = 0, bases c * 2^30 from the first amounts, less 7, as the engine's
    # last pass can make them: f = c * 2^30 + 7 lies in no bucket
    first = (base + 12345).long()
    for c in (1, 2, 3):
        far = ((first - (c << 30) - 7 + 2**31) % 2**32 - 2**31).to(torch.int32)
        assert_exact(segment_hist.hist_pass(bits, ci, far, 0),
                     segment_hist.hist_pass_plain(bits, ci, far, 0), f"far c={c}")


@pytest.mark.parametrize("case", ENGINE_CASES + ["zeros_and_twos"])
@pytest.mark.parametrize("engine", ["hist", "select"])
def test_median_engines_match_plain_and_sort(cuda, case, engine):
    if case == "zeros_and_twos":   # bars 2^30 from their base at the last pass
        amounts, ci = (t.to(cuda) for t in zeros_and_twos(2000))
    else:
        _, _, _, amounts, ci = (torch.from_numpy(a).to(cuda)
                                for a in adversarial_trades(**case))
    counters = (trace.counter("launch.H"), trace.counter("launch.F.fill_last"))
    got = median_engine(engine)(amounts, ci)
    launched = (trace.counter("launch.H") - counters[0],
                trace.counter("launch.F.fill_last") - counters[1])
    assert launched == ((9, 0) if engine == "hist" else (0, 4))
    want = median_engine(engine, plain=True)(amounts, ci)
    for a, b in zip(got, want):
        assert_exact(a, b, engine)
    ne = ci[1:] > ci[:-1]
    for a, b in zip(got, median_pairs(amounts, ci)):
        assert_exact(a[ne], b[ne], f"{engine} vs sort")


@pytest.mark.parametrize("n", FFILL_NS)
@pytest.mark.parametrize("mask", ["random", "leading_invalid", "all_valid",
                                  "none_valid"])
def test_fill_last_matches_plain(cuda, n, mask):
    _, m = _ffill_case(n, torch.float32, mask, cuda, n + 1)
    g = torch.Generator(device=cuda).manual_seed(n)
    v = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, device=cuda,
                      generator=g)
    before = trace.counter("launch.F.fill_last")
    got = prefix_scan.fill_last(v, m)
    assert trace.counter("launch.F.fill_last") == before + 1
    assert_exact(got, prefix_scan.fill_last_plain(v, m))


def _tile_edge_ci(n, tile=2048):
    """Close indices whose opens fall on kernel V's tile edges (one repeated:
    an empty bar), and trades after the last bar."""
    edges = list(range(tile - 1, n - 10, tile))
    return torch.tensor(sorted([-1] + edges + edges[2:3] + [n - 10]))


@pytest.mark.parametrize("case", [
    dict(n=300_000, seed=31, first=-1, long_bar=100_000),
    dict(n=50_000, seed=32, first=9, mean_bar=3),
    dict(n=7, seed=33, first=-1, mean_bar=2),
    dict(n=400_000, seed=34, first=5, long_bar=300_000),   # a bar over 146 tiles
    dict(n=1000, seed=35, first=-1, mean_bar=40),          # n below one tile
    dict(n=30_000, seed=36, edges=True),                   # opens on tile edges
])
def test_planes_match_plain(cuda, case):
    case = dict(case)
    edges = case.pop("edges", False)
    ticks, units, sides, _, ci = (
        torch.from_numpy(a).to(cuda) for a in adversarial_trades(**case))
    if edges:
        ci = _tile_edge_ci(len(ticks)).to(cuda)
    before = (trace.counter("launch.V"), trace.counter("launch.C"))
    got = fused_scan.bar_scan_planes(ticks, units, sides, ci)
    assert (trace.counter("launch.V"), trace.counter("launch.C")) == \
        (before[0] + 1, before[1])         # kernel V once, kernel C never
    want = fused_scan.bar_scan_planes_plain(ticks, units, sides, ci)
    for name, a, b in zip(("pre64", "pre32", "ext32", "extf"), got, want):
        assert_exact(a, b, name)
    ne = ci[1:] > ci[:-1]
    for a, b in zip(planes_products(ticks, units, sides, ci),
                    fused_scan.bar_scan_products(ticks, units, sides, ci)):
        assert_exact(a[:, ne], b[:, ne])


@pytest.mark.parametrize("n", [1, 3, 4, 4097, 4098, 4099, 1_000_002, 1_000_003])
def test_io_floor_matches_plain(cuda, n):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randint(-2**31, 2**31 - 1, (8, n), dtype=torch.int32, device=cuda,
                      generator=g)
    streams = [r.clone() for r in x]
    before = trace.counter("launch.P")
    assert_exact(fused_scan.bar_scan_io_floor(*streams),
                 fused_scan.io_floor_plain(streams), "P1")
    for k in (1, 2, 4, 8):
        assert_exact(fused_scan.bar_scan_io_floor_k(streams[0], k),
                     fused_scan.io_floor_plain([streams[0]] * k), f"P2 k={k}")
    assert_exact(fused_scan.bar_scan_io_floor_stacked(x),
                 fused_scan.io_floor_plain(x), "P3")
    # the stack at a storage offset of 1 to 3 values: row 0 misaligned too
    flat = torch.empty(8 * n + 3, dtype=torch.int32, device=cuda)
    for off in (1, 2, 3):
        y = flat[off:off + 8 * n].view(8, n)
        y.copy_(x)
        assert y.data_ptr() % 16 == 4 * off
        assert_exact(fused_scan.bar_scan_io_floor_stacked(y),
                     fused_scan.io_floor_plain(x), f"P3 at offset {off}")
    assert trace.counter("launch.P") == before + 9


# kernel R's tiles hold 2048 values (8192 where a is a float or one a row), in
# groups of 32 tiles; 2048 * 2048 + 1 values make 65 groups (17 of the wider)
REC_NS = [1, 2, 2047, 2048, 2049, 8193, 2048 * 2048 + 1, 1_000_000]


def _recurrence_case(kind, n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    b = torch.rand(n, dtype=torch.float64, device=device, generator=g)
    y0 = None
    if kind == "const":
        a = 0.99
    elif kind == "y0":
        a, y0 = 13.0 / 14.0, 5.0
    elif kind == "varying":                  # ewmst's per-step decay
        a = torch.exp(-torch.rand(n, dtype=torch.float64, device=device, generator=g))
    elif kind == "nan":
        a = torch.rand(n, dtype=torch.float64, device=device, generator=g)
        b[n // 2] = torch.nan
    else:                                    # rows, one a a row, one y0 a row
        b = torch.stack([b, -b, 2 * b])
        a = torch.tensor([[0.5], [0.9], [0.999]], dtype=torch.float64, device=device)
        y0 = torch.tensor([1.0, 2.0, -3.0], dtype=torch.float64, device=device)
    return a, b, y0


@pytest.mark.parametrize("n", REC_NS)
@pytest.mark.parametrize("kind", ["const", "y0", "varying", "nan", "rows"])
def test_recurrence_matches_plain(cuda, kind, n):
    """Within rtol 1e-12 of the terms' magnitude, NaN positions equal, and
    equal from run to run bit for bit."""
    a, b, y0 = _recurrence_case(kind, n, cuda, n)
    before = trace.counter("launch.R")
    got = scan.linear_recurrence(a, b, y0=y0)
    assert trace.counter("launch.R") == before + 1
    want = scan.linear_recurrence_plain(a, b, y0=y0)
    mag = scan.linear_recurrence_plain(a.abs() if torch.is_tensor(a) else abs(a),
                                       torch.nan_to_num(b.abs()),
                                       y0=None if y0 is None else y0.abs()
                                       if torch.is_tensor(y0) else abs(y0))
    assert_window_close(got, want, float(mag.max()), 1e-12, kind)
    for _ in range(3):
        assert_exact(scan.linear_recurrence(a, b, y0=y0), got, "run to run")


@pytest.mark.parametrize("n", REC_NS)
@pytest.mark.parametrize("kind", ["varying", "rows"])
def test_recurrence_repeats_over_50_calls(cuda, kind, n):
    """Kernel R's look-back may stop at any tile; the result must not depend
    on it: 50 calls give the same bits."""
    a, b, y0 = _recurrence_case(kind, n, cuda, n + 7)
    first = scan.linear_recurrence(a, b, y0=y0)
    for i in range(50):
        assert_exact(scan.linear_recurrence(a, b, y0=y0), first, f"call {i}")


def test_recurrence_repeats_beside_a_busy_stream(cuda):
    """With another stream keeping the SMs busy, tiles are scheduled and
    published in another pattern and look-backs stop elsewhere; the bits stay
    those of a quiet call."""
    n = 2048 * 2048 + 1
    a, b, _ = _recurrence_case("varying", n, cuda, 3)
    quiet = scan.linear_recurrence(a, b)
    x = torch.randn(4096, 4096, device=cuda)
    side = torch.cuda.Stream()
    dists = set()
    for _ in range(5):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(8):
                x = torch.tanh(x @ x * 1e-3)
        dist = torch.zeros(-(-n // scan.tile_of(a, n)), dtype=torch.int32, device=cuda)
        got = scan._kernel(a, b, None, dist)
        assert_exact(got, quiet, "beside a busy stream")
        dists.add(tuple(torch.bincount(dist.cpu().long()).tolist()))
    torch.cuda.synchronize()
    assert all(len(d) >= 2 for d in dists)   # every tile but the first looked back


@pytest.mark.parametrize("rows,n", [(1, 1), (1, 2049), (1, 2048 * 2048 + 1), (3, 5000)])
def test_recurrence_launches_one_kernel(cuda, rows, n):
    """A call of kernel R is one memset and one kernel, whatever its size."""
    from torch.profiler import ProfilerActivity, profile
    b = torch.rand(rows, n, dtype=torch.float64, device=cuda).squeeze(0)
    a = torch.rand(n, dtype=torch.float64, device=cuda)
    scan.linear_recurrence(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        scan.linear_recurrence(a, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    kernels = [m for m in names if "recurrence_kernel" in m]
    memsets = [m for m in names if "memset" in m.lower()]
    assert len(kernels) == 1 and len(memsets) == 1 and len(names) == 2, names


CSW_CASES = {"walk": (20_000, 500), "flat": (20_000, 500), "nan": (5_000, 300),
             "short_window": (3_000, 3)}


def _csw_prices(case, n, device):
    r = np.random.default_rng(5)
    if case == "flat":                     # a tick grid: ties at 0, sigma = 0
        steps = r.choice([-1, 0, 0, 0, 1], n).astype(np.float64)
        steps[1000:1700] = 0.0
        p = 100.0 + 0.5 * np.cumsum(steps)
    else:
        p = 100.0 * np.exp(np.cumsum(r.normal(0.0, 1e-3, n)))
    if case == "nan":
        p[2000] = np.nan
    return torch.from_numpy(p).to(device)


@pytest.mark.parametrize("case", list(CSW_CASES))
def test_csw_matches_plain(cuda, case):
    """Kernel W and its plain version do the same float operations: up, down
    and the critical values equal bit for bit."""
    n, w = CSW_CASES[case]
    y = torch.log(_csw_prices(case, n, cuda))
    _, sigma = structural_break._sigma(y, w)
    tables = structural_break._tables(w, cuda)
    before = trace.counter("launch.W")
    got = structural_break._sup_stat(y, sigma, w, *tables)
    assert trace.counter("launch.W") == before + 1
    want = structural_break._sup_stat_plain(y, sigma, w, *tables)
    for i, (g, v) in enumerate(zip(got, want)):
        assert_exact(g, v, f"{case} output {i}")
    cpu = structural_break.cusum_test_rolling(_csw_prices(case, n, "cpu"), w, 30)
    card = structural_break.cusum_test_rolling(_csw_prices(case, n, cuda), w, 30)
    for i, (g, v) in enumerate(zip(card, cpu)):
        assert_close(g, v, rtol=1e-12, atol=1e-12, what=f"{case} card vs cpu {i}")


@pytest.mark.parametrize("case", CSW_FILTER_CASES)
def test_csw_filter_cases_match_plain(cuda, case):
    """Kernel W on the filter's adversarial series (ties of distinct quotients
    on the subnormal grid and in the normal range, flat runs, NaN and infinite
    prices, subnormal differences, sigma at the 1e-16 edge and huge, quotients
    and products that overflow, w = 3): bit for bit its plain version."""
    y, sigma, w = (torch.from_numpy(v).to(cuda) if isinstance(v, np.ndarray) else v
                   for v in csw_filter_case(case))
    tables = structural_break._tables(w, cuda)
    stats = torch.zeros(y.shape[0], 4, dtype=torch.int32, device=cuda)
    got = structural_break._sup_stat(y, sigma, w, *tables, stats=stats)
    want = structural_break._sup_stat_plain(y, sigma, w, *tables)
    for i, (g, v) in enumerate(zip(got, want)):
        assert_exact(g, v, f"{case} output {i}")
    st = stats.cpu().numpy()
    assert (st[:, 2] <= st[:, 1]).all() and (st[:, 1] <= st[:, 0]).all()


def _profile_inputs(case, device):
    """Footprint tensors, window starts, first full window and max_levels of
    ``testing.profile_case`` or of ``"wide"``: 3,000 bars of up to 512 levels
    with float volumes, about 20 bars a window."""
    if case == "wide":
        r = np.random.default_rng(9)
        n, width = 3000, 512
        ts = PROFILE_TS[0] + np.cumsum(r.integers(1, 60, n)) * 10**9
        low = (100_000 + np.cumsum(r.integers(-40, 41, n))).astype(np.int32)
        nl = r.integers(1, width + 1, n).astype(np.int32)
        buy = (r.lognormal(0.0, 1.0, (n, width)) * (r.random((n, width)) < 0.6)).astype(np.float32)
        sell = (r.lognormal(0.0, 1.0, (n, width)) * (r.random((n, width)) < 0.6)).astype(np.float32)
        window, m = 600, None
    else:
        (low, nl, buy, sell, m), ts, window = profile_case(case), PROFILE_TS, PROFILE_WINDOW
    t = volume._footprint_tensors(ts, low, nl, buy, sell, device)
    start, first, m = volume._rolling_sizes(t[0], t[1], t[2], buy.shape[1], window * 10**9, m)
    return t, start, first, m


@pytest.mark.parametrize("path", ["shared", "global"])
@pytest.mark.parametrize("n_bins", [None, 9, 27])
@pytest.mark.parametrize("case", PROFILE_CASES + ("wide",))
def test_volume_profile_matches_plain(cuda, case, n_bins, path):
    """Kernel G's rolling mode, its grid in shared memory or (forced) in the
    global scratch, against its plain version: it adds in the same order, so
    POC, HVA, LVA and pct are equal bit for bit."""
    (_, low, nl, buy, sell), start, first, m = _profile_inputs(case, cuda)
    before = trace.counter("launch.G")
    got = volume._rolling(start, first, low, nl, buy, sell, m, n_bins, 0.6834,
                          shared_cap=0 if path == "global" else None)
    assert trace.counter("launch.G") == before + 3     # the pool's slots, the profiles, the walks
    want = volume.volume_profile_rolling_plain(start, first, low, nl, buy, sell, m, n_bins,
                                               0.6834)
    for g, w, what in zip(got, want, ("poc", "hva", "lva", "pct")):
        assert_exact(g, w, f"{case} bins {n_bins} {path} {what}")


@pytest.mark.parametrize("path", ["shared", "global"])
@pytest.mark.parametrize("n_bins", [None, 27])
def test_volume_profile_rows_match_plain(cuda, n_bins, path):
    """Kernel G's rows mode on the developing grid of 400 bars."""
    (_, low, nl, buy, sell), _, _, _ = _profile_inputs("wide", cuda)
    grid, g_lo = volume._developing_grid(low[:400], nl[:400], buy[:400], sell[:400])
    got = volume._profile_rows(grid, g_lo, n_bins, 0.6834,
                               shared_cap=0 if path == "global" else None)
    want = volume._profile_rows_plain(grid, g_lo, n_bins, 0.6834)
    for g, w, what in zip(got, want, ("poc", "hva", "lva", "pct")):
        assert_exact(g, w, f"rows bins {n_bins} {path} {what}")


SPAN_CASES = [("rows", k) for k in PROFILE_ROW_CASES] \
    + [("rolling", k) for k in PROFILE_CASES + PROFILE_EXTRA_CASES]
SPAN_PATHS = {"shared": {}, "global": {"shared_cap": 0}, "split": {"split": 4},
              "thread_walks": {"walk_warp": False}}


@pytest.mark.parametrize("path", list(SPAN_PATHS))
@pytest.mark.parametrize("va_pct", [68.34, 99.999, 100.0])
@pytest.mark.parametrize("n_bins", [None, 9, 27])
@pytest.mark.parametrize("mode,name", SPAN_CASES, ids=[f"{a}-{b}" for a, b in SPAN_CASES])
def test_volume_profile_span_cases_match_plain(cuda, mode, name, n_bins, va_pct, path):
    """Kernel G on each profile's span, on the adversarial profiles of
    ``testing.profile_rows_case`` and ``profile_case`` (pair ties, equal
    running minima, NaN levels, walks to either end and into the zeros past
    the span, no volume, one level, the clip column, ``max_levels`` above every
    span), in one shared-memory launch, on the global-scratch grid, split by
    span over launches of 4, 8, 16, ... levels, and with its walks a thread
    each (these few profiles take a warp each by default): equal to the plain
    version bit for bit."""
    before = trace.counter("launch.G")
    if mode == "rows":
        grid, lo = profile_rows_case(name)
        g = torch.from_numpy(grid).to(cuda)
        got = volume._profile_rows(g, lo, n_bins, va_pct / 100.0, **SPAN_PATHS[path])
        want = volume._profile_rows_plain(g, lo, n_bins, va_pct / 100.0)
    else:
        (_, low, nl, buy, sell), start, first, m = _profile_inputs(name, cuda)
        got = volume._rolling(start, first, low, nl, buy, sell, m, n_bins, va_pct / 100.0,
                              **SPAN_PATHS[path])
        want = volume.volume_profile_rolling_plain(start, first, low, nl, buy, sell, m, n_bins,
                                                   va_pct / 100.0)
    assert trace.counter("launch.G") > before
    for g_, w, what in zip(got, want, ("poc", "hva", "lva", "pct")):
        assert_exact(g_, w, f"{mode} {name} bins {n_bins} va {va_pct} {path} {what}")



def test_chain_kernel_path_matches_plain(cuda):
    """The chain of ``chip_smoke.py`` phase 11 at 1M trades: ``TradesData``,
    time bars, the pipeline with config 4's features, CUSUM events,
    ``TBMLabel`` over the trades, the info and final weights, the z-score
    filter; the kernel path against the plain path with that phase's checks
    (bars, features, events, indices and labels exact, weights at their prefix
    magnitude, z-score events equal off the ties; kernel Z's events against the
    host loop's), the final weights equal run to run, B, S and R launched, and
    Z once."""
    import chip_smoke
    ts, price, amount, side = chip_smoke.synth_trades(1_000_000, seed=3)
    month = dict(n=len(ts), ts=ts, price=price, amount=amount, side=side)
    trades, _ = chip_smoke.chain_trades(month)
    _, graph = chip_smoke.chain_graph()
    counts = (trace.counter("launch.B"), trace.counter("launch.S"), trace.counter("launch.R"))
    z = trace.counter("launch.Z")
    k, _ = chip_smoke.run_chain(trades, graph)
    assert trace.counter("launch.B") > counts[0] and trace.counter("launch.S") > counts[1] \
        and trace.counter("launch.R") > counts[2]
    assert trace.counter("launch.Z") == z + 1
    z = trace.counter("launch.Z")
    p, _ = chip_smoke.run_chain(trades, graph, plain=True)
    assert trace.counter("launch.Z") == z       # the plain run walks on the host
    chip_smoke.check_chain(k, p, trades)
    again, _ = chip_smoke.run_chain(trades, graph)
    for key in k["final"]:
        assert_exact(again["final"][key], k["final"][key], f"final {key} run to run")
    assert k["out"]["labels"].shape[0] > 10


def test_class_balance_repeats(cuda):
    """``class_balance_weights`` sums each class without float atomics: equal
    bits over runs, and to its CPU run within rounding."""
    from finmlkit_tpu_torch.label.weights import class_balance_weights
    g = torch.Generator(device="cuda").manual_seed(11)
    labels = torch.randint(-1, 2, (3_000_000,), device=cuda, generator=g).to(torch.int8)
    base = torch.rand(3_000_000, dtype=torch.float64, device=cuda, generator=g)
    first = class_balance_weights(labels, base)
    for _ in range(5):
        for a, b in zip(class_balance_weights(labels, base), first):
            assert_exact(a, b, "class balance run to run")
    cpu = class_balance_weights(labels.cpu(), base.cpu())
    assert_exact(first[0], cpu[0], "classes")
    for a, b in zip(first[1:], cpu[1:]):
        assert_close(a, b, rtol=1e-12)


# --- the float64 path of trades on no tick grid: kernel D, S and C ----------

WALK_N = 1_000_000


def _off_grid(n, device, seed=31):
    """Prices on no tick grid and float32 amounts, on ``device``."""
    g = np.random.default_rng(seed)
    px = 107_000.0 * np.exp(np.cumsum(g.normal(0, 2e-5, n)))
    v = np.maximum(g.lognormal(-4.0, 1.5, n), 1e-5).astype(np.float32)
    v[::997] *= 500                        # trades above the threshold alone
    side = np.where(g.random(n) < 0.5, 1, -1).astype(np.int8)
    side[::13] = 0
    return (torch.from_numpy(px).to(device), torch.from_numpy(v).to(device),
            torch.from_numpy(side).to(device))


def _walks(mode, px, v, thr, mb):
    if mode == "volume":
        return (lambda: float_walk.volume_walk(v, thr, mb),
                lambda: float_walk.volume_walk_plain(v, thr, mb))
    return (lambda: float_walk.dollar_walk(px, v, thr, mb),
            lambda: float_walk.dollar_walk_plain(px, v, thr, mb))


def _route_delta(before):
    return [a - b for a, b in zip(float_walk.route_launches(), before)]


def _one_walk(mode, px, v, thr):
    """The route counters' change of one walk of the stream: the block walk
    outside the warp step's domain, units for a volume walk of the exact-sum
    case, else the warp step."""
    values = (v.double() if mode == "volume" else px * v.double()).cpu().numpy()
    if not float_walk.in_warp_domain(values, thr):
        route = float_walk.BLOCK
    elif mode == "volume" and float_walk.exact_unit(values, thr) is not None:
        route = float_walk.UNITS
    else:
        route = float_walk.WARP
    return [int(r == route) for r in range(3)]


def _dusted(v):
    """``v`` with one dust trade of 2^-100: its volume walks leave the
    exact-sum case for the warp step."""
    v = v.clone()
    v[v.shape[0] // 2] = 2.0 ** -100
    return v


@pytest.mark.parametrize("dust", [False, True])
@pytest.mark.parametrize("mode", ["volume", "dollar"])
@pytest.mark.parametrize("share,cap", [(1 / 2000, None), (1 / 20, None),
                                       (1 / 200_000, None), (1 / 2000, 100),
                                       (1 / 2000, 1), (1 / 2000, 0)])
def test_float_walk_matches_plain(cuda, mode, share, cap, dust):
    """Kernel D's closes against its plain loop, exactly, and run to run; one
    walk a call, by the route the stream calls for (the volume draws in units,
    with a dust trade by the warp step)."""
    px, v, _ = _off_grid(WALK_N, cuda)
    if dust:
        v = _dusted(v)
    values = v.to(torch.float64) if mode == "volume" else px * v.to(torch.float64)
    total = float(values.sum())
    thr = share * total
    mb = int(total / thr) + 2 if cap is None else cap
    kernel, plain = _walks(mode, px, v, thr, mb)
    before, routes = trace.counter("launch.D"), float_walk.route_launches()
    got = kernel()
    torch.cuda.synchronize()
    assert trace.counter("launch.D") == before + (mb > 0)
    want_route = _one_walk(mode, px, v, thr) if mb > 0 else [0, 0, 0]
    assert _route_delta(routes) == want_route
    if mode == "volume" and mb > 0:
        assert want_route[float_walk.WARP if dust else float_walk.UNITS] == 1
    want = plain()
    assert_exact(got, want, f"{mode} D vs plain")
    assert_exact(kernel(), got, f"{mode} D run to run")
    if cap is not None:
        assert len(got) == cap


@pytest.mark.parametrize("special", ["negatives", "nan", "inf", "dyadic"])
@pytest.mark.parametrize("mode", ["volume", "dollar"])
def test_float_walk_special_values(cuda, mode, special):
    """A negative value, a NaN or an infinity sends the stream to the block
    walk (the general route); sums that hit the threshold exactly take the
    warp step (dollar) or units (volume); each route's closes equal the plain
    loop's."""
    px, v, _ = _off_grid(WALK_N, cuda, seed=37)
    if special == "negatives":
        v[::7] *= -1.0
    elif special == "nan":
        v[500_001] = float("nan")
    elif special == "inf":
        v[700_003] = float("inf")
    else:                                   # eighths: every sum exact
        v = torch.randint(0, 8, (WALK_N,), device=cuda).to(torch.float32) / 8.0
        px = torch.full_like(px, 2.0)
    values = v.to(torch.float64) if mode == "volume" else px * v.to(torch.float64)
    finite = values[torch.isfinite(values)]
    thr = 2.0 if special == "dyadic" else float(finite.abs().sum()) / 5000
    want_route = ([0, 0, 1] if mode == "volume" else [1, 0, 0]) if special == "dyadic" \
        else [0, 1, 0]
    assert _one_walk(mode, px, v, thr) == want_route
    for cap in (WALK_N, 17):
        kernel, plain = _walks(mode, px, v, thr, cap)
        routes = float_walk.route_launches()
        assert_exact(kernel(), plain(), f"{mode} {special} cap {cap}")
        assert _route_delta(routes) == want_route


@pytest.mark.parametrize("thr", [0.0, -1.0, float("inf"), float("nan"), 2.0 ** -961])
@pytest.mark.parametrize("mode", ["volume", "dollar"])
def test_float_walk_thresholds_outside_the_warp_step(cuda, mode, thr):
    """A threshold at most 0, not finite or below 2^-960 takes the block walk."""
    px, v, _ = _off_grid(20_000, cuda, seed=41)
    kernel, plain = _walks(mode, px, v, thr, 20_000)
    routes = float_walk.route_launches()
    assert_exact(kernel(), plain(), f"{mode} thr {thr}")
    assert _route_delta(routes) == [0, 1, 0]


@pytest.mark.parametrize("n", [1, 2, 767, 768, 769, 1535, 1536, 1537, 2047, 2048, 2049,
                               4096, 4097, 10_241])
def test_float_walk_chunk_edges(cuda, n):
    """D's tiles of 768 trades and the block walk's chunks of 2048: a close
    at every trade (the threshold below every amount) and at none, on both
    modes and on each route (the stream as drawn, with a dust trade, with one
    amount negated), against plain, with the route counters."""
    px, v, _ = _off_grid(n, cuda, seed=n)
    neg = v.clone()
    neg[n // 2] = -neg[n // 2]
    for stream, vs in (("drawn", v), ("dust", _dusted(v)), ("negative", neg)):
        for mode in ("volume", "dollar"):
            for thr in (1e-9, 1e30):
                kernel, plain = _walks(mode, px, vs, thr, n)
                routes = float_walk.route_launches()
                assert_exact(kernel(), plain(), f"{mode} n {n} {stream} thr {thr}")
                want_route = _one_walk(mode, px, vs, thr)
                assert _route_delta(routes) == want_route
                if stream == "negative":
                    assert want_route == [0, 1, 0]


def _warp_case(name, device):
    px, v, thr_v, thr_d, cap = float_walk_case(name)
    return (torch.from_numpy(px).to(device), torch.from_numpy(v).to(device), thr_v, thr_d,
            cap)


@pytest.mark.parametrize("chunks", [1, 2, 7, 64])
@pytest.mark.parametrize("name", FLOAT_WALK_CASES)
def test_float_walk_warp_streams_match_plain(cuda, name, chunks):
    """The streams of the CPU model's tests: the volume walk as drawn (units
    where it is in the exact-sum case), the volume walk with a dust trade by
    the warp step at each chunk count, and the dollar walk by the warp step,
    close for close, with the warp step's counts."""
    px, v, thr_v, thr_d, cap = _warp_case(name, cuda)
    dv = _dusted(v)
    st = torch.zeros(len(float_walk.STATS), dtype=torch.int64, device=cuda)
    routes = float_walk.route_launches()
    got = float_walk._launch(float_walk._VOLUME, None, dv, thr_v, cap, chunks=chunks, stats=st)
    assert_exact(got, float_walk.volume_walk_plain(dv, thr_v, cap),
                 f"{name} volume with dust, {chunks}")
    assert _route_delta(routes) == [1, 0, 0]
    routes = float_walk.route_launches()
    assert_exact(float_walk._launch(float_walk._VOLUME, None, v, thr_v, cap, chunks=chunks),
                 float_walk.volume_walk_plain(v, thr_v, cap), f"{name} volume, {chunks}")
    want_d = float_walk.dollar_walk_plain(px, v, thr_d, cap)
    assert_exact(float_walk._launch(float_walk._DOLLAR, px, v, thr_d, cap, chunks=chunks),
                 want_d, f"{name} dollar")
    assert _route_delta(routes) == [a + b for a, b in zip(_one_walk("volume", px, v, thr_v),
                                                          [1, 0, 0])]
    counts = dict(zip(float_walk.STATS, st.tolist()))
    assert counts["closes"] >= len(got)
    if chunks == 1:
        assert counts["unmerged"] == counts["fixed"] == 0


@pytest.mark.parametrize("chunks", [1, 33, 132, 528])
def test_float_walk_volume_chunks_on_a_large_stream(cuda, chunks):
    """The volume walk of 5M off-grid trades with a dust trade at total / 5000
    (the warp step) is one set of closes at every chunk count."""
    px, v = offgrid_trades(5_000_000, 3)
    v = _dusted(torch.from_numpy(v).to(cuda))
    thr = float(v.double().sum()) / 5000
    want = float_walk.volume_walk_plain(v, thr, 6000)
    routes = float_walk.route_launches()
    assert_exact(float_walk._launch(float_walk._VOLUME, None, v, thr, 6000, chunks=chunks),
                 want, f"volume at {chunks} chunks")
    assert _route_delta(routes) == [1, 0, 0]


def test_float_range_sums_match_cumsum(cuda):
    """The float64 range sums on kernel S (``range_sum``) and on kernel C
    (``range_sums``, one launch over a (7, n) stack) against the same sums
    from ``torch.cumsum``, each prefix within rtol 1e-12 as phase 3 holds the
    float64 scans (so a sum within 2e-12 of the largest prefix), and equal
    run to run."""
    from finmlkit_tpu_torch.ops.segment import prefix_differences, range_sum, range_sums
    g = torch.Generator(device="cuda").manual_seed(41)
    n = 5_000_001
    x = torch.randn((7, n), dtype=torch.float64, device=cuda, generator=g) * 100.0
    ci = torch.unique(torch.randint(0, n, (20_000,), device=cuda, generator=g))
    ci = torch.cat([torch.tensor([-1], device=cuda), ci, torch.tensor([n - 1], device=cuda)])
    want = prefix_differences(torch.cumsum(x, 1), ci)
    s_before, c_before = trace.counter("launch.S.float"), trace.counter("launch.C")
    got1 = range_sum(x[0], ci)
    got7 = range_sums(x, ci)
    assert trace.counter("launch.S.float") == s_before + 1
    assert trace.counter("launch.C") == c_before + 1
    P = torch.cumsum(x, 1).abs().amax(1)
    for r in range(7):
        assert_within(got7[r], want[r], 2e-12 * float(P[r]), f"range_sums row {r}")
    assert_within(got1, want[0], 2e-12 * float(P[0]), "range_sum")
    assert_exact(range_sums(x, ci), got7, "range_sums run to run")


def test_aggregate_launches_s_and_c_and_matches_plain(cuda):
    """``bar/aggregate.py`` on the card launches S (the bar ids and the float64
    sums) and C (the directional stacks), and its outputs hold to its plain
    path on the card as ``testing.hold_float_path`` sets out."""
    from finmlkit_tpu_torch.bar import aggregate
    n = 2_000_000
    px, v, side = _off_grid(n, cuda, seed=43)
    ci = torch.arange(-1, n, 700, device=cuda)
    ci = torch.cat([ci[:5], ci[4:5], ci[5:]])           # an empty bar
    plain = dict(cumsum=prefix_scan.fast_cumsum_plain)
    s0, f0, c0 = (trace.counter(k) for k in ("launch.S", "launch.S.float", "launch.C"))
    o = aggregate.comp_bar_ohlcv(px, v, ci)
    assert (trace.counter("launch.S") - s0, trace.counter("launch.S.float") - f0) == (3, 2)
    d = aggregate.comp_bar_directional_features(px, v, ci, side)
    assert trace.counter("launch.C") - c0 == 2 and trace.counter("launch.S") - s0 == 4
    theta = o["median_trade_size"]
    t = aggregate.comp_bar_trade_size_features(v, theta, ci, 5.0)
    assert (trace.counter("launch.S") - s0, trace.counter("launch.S.float") - f0) == (8, 5)
    po = aggregate.comp_bar_ohlcv(px, v, ci, **plain)
    pd_ = aggregate.comp_bar_directional_features(
        px, v, ci, side, cumsum_cols=prefix_scan.fast_cumsum_cols_plain, **plain)
    pt = aggregate.comp_bar_trade_size_features(v, theta, ci, 5.0, **plain)
    assert (trace.counter("launch.S") - s0, trace.counter("launch.C") - c0) == (8, 2)
    for got, want in ((o, po), (d, pd_), (t, pt)):
        hold_float_path(got, want, px, v, po["volume"], "card vs plain")


def test_off_grid_kits_match_plain(cuda):
    """The kits on trades off every tick grid, on the card against
    ``plain=True`` on the card: closes exact (kernel D), products held by
    ``testing.hold_float_path``, footprints bit for bit."""
    from finmlkit_tpu_torch.bar import kit
    n = 400_000
    px, v, side = _off_grid(n, "cpu", seed=47)
    ts = 1_751_328_000_000_000_000 + np.cumsum(np.full(n, 70_000_000, np.int64))
    px, v, side = px.numpy(), v.numpy(), side.numpy()
    thr = float((px * v.astype(np.float64)).sum()) / 300
    before = trace.counter("launch.D")
    k = kit.DollarBarKit(ts, px, v, side, thr)
    p = kit.DollarBarKit(ts, px, v, side, thr, plain=True)
    assert_exact(k.bar_close_indices, p.bar_close_indices, "dollar closes")
    assert trace.counter("launch.D") == before + 1
    vk = kit.VolumeBarKit(ts, px, v, side, float(v.sum()) / 300)
    vp = kit.VolumeBarKit(ts, px, v, side, float(v.sum()) / 300, plain=True)
    assert_exact(vk.bar_close_indices, vp.bar_close_indices, "volume closes")
    ko, po = k.build_ohlcv(), p.build_ohlcv()
    for got, want in ((ko, po), (k.build_directional_features(),
                                 p.build_directional_features())):
        hold_float_path(got, want, px, v, po["volume"], "kit vs plain")
    kf, pf = k.build_footprints(0.1), p.build_footprints(0.1)
    for key in kf:
        assert_exact(kf[key], pf[key], f"footprints {key}")


def _klines_trades(n=400_000, seed=21):
    """``chip_smoke.synth_trades`` at ``n`` trades, spread over three days so
    that the seconds have some empty ones, as a ``TradesData``."""
    import chip_smoke
    from finmlkit_tpu_torch.bar import TradesData
    ts, price, amount, side = chip_smoke.synth_trades(n, seed=seed)
    ts = ts[0] + (ts - ts[0]) * 4       # about 280 ms apart: empty seconds
    return TradesData(ts, price, amount, side=side, timestamp_unit="ns")


@pytest.mark.parametrize("timeframe", ["1s", "7s", "1min", "1h", "1D"])
def test_resample_matches_plain(cuda, timeframe):
    """The klines' resample on the card, kernel S for the group ids and the
    median's running counts, against its plain version on the card (exact)
    and the numpy oracle of ``chip_smoke.py`` (OHLC, trades and median exact,
    volume and vwap within 2^-22)."""
    import chip_smoke
    from finmlkit_tpu_torch.data import klines
    bars = klines.build_klines(_klines_trades())
    assert int((bars["trades"] == 0).sum()) > 100
    before = trace.counter("launch.S")
    got = klines.resample(bars, timeframe)
    assert trace.counter("launch.S") == before + 2
    plain = klines.resample(bars, timeframe, plain=True)
    for k, v in plain.items():
        assert v.device.type == "cuda"
        assert_exact(got[k], v, f"{timeframe} {k}")
    host = {k: v.cpu().numpy() for k, v in bars.items()}
    oracle = chip_smoke.resample_numpy(host["timestamp"], host,
                                       klines.parse_timeframe(timeframe))
    chip_smoke.hold_resample(got, oracle, f"resample {timeframe}")


def test_build_klines_matches_plain(cuda):
    """The 1-second klines through kernels B and S against the plain versions
    on the card, bit for bit."""
    from finmlkit_tpu_torch.data import klines
    trades = _klines_trades(seed=22)
    counts = (trace.counter("launch.B"), trace.counter("launch.S"))
    got = klines.build_klines(trades)
    assert (trace.counter("launch.B"), trace.counter("launch.S")) == (counts[0] + 1, counts[1] + 1)
    want = klines.build_klines(trades, plain=True)
    for k, v in want.items():
        assert_exact(got[k], v, k)


@pytest.mark.parametrize("case", [dict(n=200_000, seed=0), dict(n=50_000, seed=3, mean_bar=2),
                                  dict(n=300_000, seed=5, long_bar=123_456, first=20)])
def test_host_medians_on_card_tensors(cuda, case):
    """``medians="host"`` takes card tensors and gives its pair back on the
    card, equal to the sort engine's on the non-empty bars; the finals of
    ``bar_products_final`` equal, bit for bit."""
    from finmlkit_tpu_torch.bar.fused import bar_products_final
    ticks, units, sides, amounts, ci = (torch.from_numpy(a).to(cuda) for a in
                                        adversarial_trades(**case))
    ha, hb = median_engine("host")(amounts, ci)
    sa, sb = median_engine("sort")(amounts, ci)
    assert ha.device.type == "cuda"
    full = (ci[1:] - ci[:-1]) > 0
    assert_exact(ha[full], sa[full], "med_a")
    assert_exact(hb[full], sb[full], "med_b")
    kw = dict(tick_size=0.1, amount_scale=1e-8, amounts_f32=amounts)
    host = bar_products_final(ticks, units, ci, sides, medians="host", **kw)
    sort = bar_products_final(ticks, units, ci, sides, **kw)
    for part in (0, 1):
        for k, v in sort[part].items():
            assert_exact(host[part][k], v, k)


def test_store_round_trip_on_card(cuda, tmp_path):
    """Where h5py imports: a store saved and loaded back, its klines built on
    the card equal to the CPU's, and a resampled read on the card held to the
    CPU's (the float sums may add in another order)."""
    pytest.importorskip("h5py")
    from finmlkit_tpu_torch.data import klines, store
    trades = _klines_trades(n=200_000, seed=23)
    path = str(tmp_path / "s.h5")
    trades.save_h5(path)
    back = store.load_trades_h5(path)
    for k, v in trades.data.items():
        assert_exact(back.data[k], v, k)
    cpu_path = str(tmp_path / "cpu.h5")
    trades.save_h5(cpu_path)
    assert all(klines.AddTimeBarH5(path).process_all().values())
    assert all(klines.AddTimeBarH5(cpu_path, device="cpu").process_all().values())
    import chip_smoke
    card, cpu = klines.TimeBarReader(path), klines.TimeBarReader(cpu_path, device="cpu")
    got, want = card.read(), cpu.read()
    assert got["timestamp"].device.type == "cuda"
    for k, v in want.items():
        assert_exact(got[k], v, k)
    chip_smoke.hold_resample(card.read(timeframe="1min"), cpu.read(timeframe="1min"),
                             "the card's 1min read vs the CPU's")


# --- entry and exit states of kernels E and D -------------------------------

from finmlkit_tpu_torch.testing import (D_ENTRY_CASES, E_ENTRY_CASES,  # noqa: E402
                                       d_entry_case, e_entry_case, same_state)

ENTRY_N = 2048 * 200 + 17          # 201 tiles: 132 chunks of whole tiles


@pytest.mark.parametrize("chunks", [1, None, 132])
@pytest.mark.parametrize("name", E_ENTRY_CASES)
def test_event_scan_entry_state_matches_plain(cuda, name, chunks):
    """Kernel E from an adversarial entry state against its plain version:
    the closes and the exit state bit for bit, at 1, the default and 132
    chunks."""
    mode, start, kw, plain = e_entry_case(name, ENTRY_N, cuda)
    want, want_end = plain(ENTRY_N)
    got, end = event_scan._launch(mode, ENTRY_N, start, ENTRY_N, cuda, chunks=chunks,
                                  exit_state=True, **kw)
    assert_exact(got, want, name)
    assert same_state(end, want_end), (end, want_end)
    assert len(want) > 10


def _split_scans(mode, n, k, kw, start):
    """Kernel E over [0, k) and then over [k, n) from its exit state."""
    whole = event_scan._launch(mode, n, start, n, kw["dev"], exit_state=True,
                               **kw["args"])
    cut = {key: (t[:k] if torch.is_tensor(t) and t.dim() == 1 else t)
           for key, t in kw["args"].items()}
    rest = {key: (t[k:] if torch.is_tensor(t) and t.dim() == 1 else t)
            for key, t in kw["args"].items()}
    a, mid = event_scan._launch(mode, k, start, n, kw["dev"], exit_state=True, **cut)
    info = (event_scan._IMBALANCE, event_scan._RUN, event_scan._IMBALANCE_MAP,
            event_scan._RUN_COUNT)
    if mode in info:
        mid = mid[:4] + (mid[4] - k,)            # open relative to the second part
    b, end = event_scan._launch(mode, n - k, 0, n, kw["dev"], exit_state=True,
                                entry=mid, **rest)
    if mode in info:
        end = end[:4] + (end[4] + k,)
    return whole, (torch.cat([a, b + k]), end)


@pytest.mark.parametrize("where", ["tile", "chunk", "close", "mid"])
@pytest.mark.parametrize("mode", ["cusum", "imbalance", "run", "volume", "map", "run_count"])
def test_event_scan_split_equals_whole(cuda, mode, where):
    """A stream scanned in two parts, the second from the first's exit state,
    gives the whole scan's closes and exit state (exact sums)."""
    n = ENTRY_N
    g = np.random.default_rng(3)
    if mode == "cusum":
        r = torch.from_numpy(g.integers(-64, 65, n) * 2.0 ** -20).to(cuda)
        args = dict(x=r, lam=torch.full((n,), 2.0 ** -8, dtype=torch.float64, device=cuda),
                    can_close=torch.from_numpy(g.random(n) < 0.9).to(cuda))
        m, start = event_scan._CUSUM, 1
    elif mode == "volume":
        args = dict(units=torch.from_numpy(g.integers(1, 200, n)).to(cuda), thr=5000)
        m, start = event_scan._VOLUME, 1
    elif mode == "map":
        args = dict(x=torch.from_numpy(np.where(g.random(n) < 0.5, 1.0, -1.0)).to(cuda),
                    e_t=1.0, e_r=30.0)
        m, start = event_scan._IMBALANCE_MAP, 1
    elif mode == "run_count":
        args = dict(x=torch.from_numpy(g.integers(-1, 2, n).astype(np.float64)).to(cuda),
                    e_t=40.0, e_r=0.75, alpha_t=0.05, alpha_r=0.05)
        m, start = event_scan._RUN_COUNT, 1
    else:
        w = g.integers(-8, 9, n) if mode == "run" else g.integers(-6, 11, n)  # a drift
        args = dict(x=torch.from_numpy(w / 8.0).to(cuda), e_t=40.0,
                    e_r=0.75 if mode == "run" else 0.25, alpha_t=0.05, alpha_r=0.05)
        m, start = (event_scan._RUN if mode == "run" else event_scan._IMBALANCE), 1
    closes = event_scan._launch(m, n, start, n, cuda, **args)
    assert len(closes) > 10
    k = {"tile": start + 2048 * 37, "chunk": start + 2048 * 100,
         "close": int(closes[len(closes) // 2]) + 1, "mid": 150_001}[where]
    (w, w_end), (s, s_end) = _split_scans(m, n, k, {"dev": cuda, "args": args}, start)
    assert_exact(s, w, f"{mode} split at {k}")
    assert same_state(s_end, w_end), (s_end, w_end)


@pytest.mark.parametrize("entry", ["split", "below_thr"])
@pytest.mark.parametrize("name", D_ENTRY_CASES)
def test_float_walk_entry_sum_matches_plain(cuda, name, entry):
    """Kernel D from an entry sum against its plain loop, closes and exit sum
    bit for bit, on each route: the exit sum of the stream's first third
    (the walk of the rest then equals the whole walk's tail), or one ulp
    below the threshold (not a whole number of units: the warp step)."""
    mode, px, v, thr = d_entry_case(name, WALK_N, cuda)
    walk = float_walk.volume_walk if mode == "volume" else float_walk.dollar_walk
    plain = float_walk.volume_walk_plain if mode == "volume" else float_walk.dollar_walk_plain
    args = (lambda a, b: (v[a:b],)) if mode == "volume" else (lambda a, b: (px[a:b], v[a:b]))
    k = WALK_N // 3
    whole, whole_end = walk(*args(0, WALK_N), thr, WALK_N, exit_state=True)
    if entry == "split":
        head, state = walk(*args(0, k), thr, WALK_N, exit_state=True)
        want_head, want_state = plain(*args(0, k), thr, WALK_N, exit_state=True)
        assert_exact(head, want_head, "head")
        assert same_state(state, want_state)
    else:
        state = float(np.nextafter(thr, 0.0))
    before = float_walk.route_launches()
    got, end = walk(*args(k, WALK_N), thr, WALK_N, state=state, exit_state=True)
    routes = _route_delta(before)
    want, want_end = plain(*args(k, WALK_N), thr, WALK_N, state=state, exit_state=True)
    assert_exact(got, want, f"{name} from {state}")
    assert same_state(end, want_end), (end, want_end)
    if entry == "split":
        assert_exact(torch.cat([head, got + k]), whole, "split against whole")
        assert same_state(end, whole_end)
    route = {"units": float_walk.UNITS, "warp": float_walk.WARP,
             "block": float_walk.BLOCK, "dollar_warp": float_walk.WARP,
             "dollar_block": float_walk.BLOCK}[name]
    if name == "units" and entry == "below_thr":
        route = float_walk.WARP             # not a whole number of units
    assert routes == [int(r == route) for r in range(3)], routes


# --- the sharded layer on the card ---------------------------------------------

@pytest.mark.parametrize("ranks,backend", [(2, "gloo"), (1, "nccl")])
def test_sharded_layer_on_the_card(cuda, ranks, backend):
    """``parallel/dryrun.py``'s flow on ranks sharing the card (gloo), and on
    one nccl rank: every indexer, the products, footprints, profile, labels
    and weights against the single-device functions on the card."""
    from finmlkit_tpu_torch.parallel import dryrun
    from finmlkit_tpu_torch.parallel.mesh import spawn_mesh
    res = spawn_mesh(dryrun._dryrun_rank, ranks, args=(50_000, 7), backend=backend,
                     device="cuda", timeout=300)
    for r in res:
        assert r["bad"] == [], r["bad"]
        assert min(r["bars"].values()) > 5


def test_sharded_indexers_staged_on_the_card(cuda):
    """The indexers with every collective staged through pinned host memory
    (as where gloo refuses CUDA tensors) give the same closes."""
    from finmlkit_tpu_torch.parallel import dryrun
    from finmlkit_tpu_torch.parallel.mesh import spawn_mesh
    spec = dict(n=200_000, seed=0, sigma=2e-5, volume_bars=500, dollar_bars=500,
                interval=60.0, ticks=1000, floor=1e-9, mult=60.0, theta=30.0,
                run=dict(expected_ticks_init=1000.0, expected_rate_init=0.5,
                         alpha_ticks=0.05, alpha_rate=0.05), only="indexers", stage=True)
    res = spawn_mesh(dryrun.month_path, 2, args=(spec,), device="cuda", timeout=300)
    assert all(r["staged_same"] and r["staged_bytes"] > 0 for r in res)
    assert res[0]["digests"] == res[1]["digests"]
    assert res[0]["launches"]["E cusum"] >= 1 and res[0]["launches"]["D"] >= 1


def test_sharded_run_bars_take_the_count_search(cuda):
    """The sharded ring's tick run bars on two ranks sharing the card: every
    span takes the count search (no walk), from the whole sums the span before
    left, and the closes are the single-device indexer's."""
    from finmlkit_tpu_torch.bar.indexers import run_bar_indexer
    from finmlkit_tpu_torch.parallel import dryrun
    from finmlkit_tpu_torch.parallel.mesh import spawn_mesh
    from finmlkit_tpu_torch.testing import bench_trades
    run = dict(expected_ticks_init=1000.0, expected_rate_init=0.5, alpha_ticks=0.05,
               alpha_rate=0.05)
    spec = dict(n=2_000_000, seed=5, sigma=2e-5, volume_bars=500, dollar_bars=500,
                interval=60.0, ticks=1000, floor=1e-9, mult=60.0, theta=30.0, run=run,
                only="indexers")
    res = spawn_mesh(dryrun.month_path, 2, args=(spec,), device="cuda", timeout=300)
    ts, _, _, side = bench_trades(spec["n"], spec["seed"])
    want = run_bar_indexer(torch.from_numpy(ts).to(cuda), torch.from_numpy(side).to(cuda),
                           **run)[1]
    assert want.shape[0] > 100
    for r in res:
        assert r["digests"]["ci.run"] == dryrun._digest(want.cpu().numpy()), r["rank"]
        assert r["launches"]["E run_count"] >= 1, r["launches"]
        assert r["launches"]["E run"] == r["launches"]["E run_count"], r["launches"]


# --- host reads on the card: every synchronizing call is a counted read ----------

def _pass_calls(dev):
    """The benchmark's two passes on 300,000 trades of the synthetic month on
    the card, each entry a call with its inputs made by the ones before it."""
    from finmlkit_tpu_torch import interop
    from finmlkit_tpu_torch.bar.footprint_q import bar_footprints
    from finmlkit_tpu_torch.bar.fused import bar_products_final
    from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    from finmlkit_tpu_torch.label.tbm import triple_barrier
    from finmlkit_tpu_torch.label.weights import average_uniqueness, return_attribution
    from finmlkit_tpu_torch.sampling.filters import cusum_filter
    from finmlkit_tpu_torch.testing import bench_trades
    ts, price, amount, side = bench_trades(300_000, 3)
    tr = interop.from_numpy(quantize_trades(price, amount), None, side, amount, dev,
                            timestamps=ts)
    first, last = int(ts[0]), int(ts[-1])
    kw = dict(tick_size=tr.tick_size, amount_scale=tr.amount_scale, amounts_f32=tr.amounts)
    clock, ci_t = time_bar_indexer(tr.timestamps, 60.0, ts_first=first, ts_last_i=last)
    close = bar_products_final(tr.ticks, tr.units, ci_t, tr.sides, **kw)[0]["close"]
    bar_ts = clock[1:ci_t.shape[0]]
    ev = cusum_filter(close, [0.002])
    ev = ev[ev < close.shape[0] - 60]
    tgt = torch.full((ev.shape[0],), 0.003, dtype=torch.float64, device=dev)
    touch = triple_barrier(bar_ts, close, ev, tgt, (1, 1), 3600.0)[1]
    conc = average_uniqueness(bar_ts, ev, touch)[1]
    thr = float((price * amount.astype(np.float64)).sum()) / 1000
    ci_d = dollar_bar_indexer_q(tr.timestamps, tr.ticks, tr.units, thr, tr.tick_size,
                                tr.amount_scale)[1]
    ohlcv = bar_products_final(tr.ticks, tr.units, ci_d, tr.sides, **kw)[0]
    return {
        "time_bar_indexer": lambda: time_bar_indexer(tr.timestamps, 60.0, ts_first=first,
                                                     ts_last_i=last),
        "bar_products_final": lambda: bar_products_final(tr.ticks, tr.units, ci_t, tr.sides,
                                                         **kw),
        "cusum_filter": lambda: cusum_filter(close, [0.002]),
        "triple_barrier": lambda: triple_barrier(bar_ts, close, ev, tgt, (1, 1), 3600.0),
        "average_uniqueness": lambda: average_uniqueness(bar_ts, ev, touch),
        "return_attribution": lambda: return_attribution(ev, touch, close, conc),
        "dollar_bar_indexer_q": lambda: dollar_bar_indexer_q(
            tr.timestamps, tr.ticks, tr.units, thr, tr.tick_size, tr.amount_scale),
        "bar_footprints": lambda: bar_footprints(tr.ticks, tr.amounts, ci_d, tr.sides, ohlcv,
                                                 tick_size=tr.tick_size, price_tick_size=0.1,
                                                 imbalance_factor=3.0),
        "bar_trade_size_features": lambda: bar_trade_size_features(
            tr.units, tr.amounts, ci_d, ohlcv["median_trade_size"], theta_mult=5.0,
            amount_scale=tr.amount_scale),
    }


def test_every_sync_of_an_entry_is_a_counted_read(cuda):
    """Under ``torch.cuda.set_sync_debug_mode("warn")`` each benchmarked
    entry raises exactly as many synchronizing warnings as the trace registry
    counts ``host_read``s in its span, so that no read escapes the count."""
    import warnings
    calls = _pass_calls(cuda)
    got = {}
    for name, call in calls.items():
        call()                                     # warm: the allocator, lazy loads
        torch.cuda.synchronize()
        before = trace.report().get(name, {}).get("reads", 0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        got[name] = (len(syncs), trace.report()[name]["reads"] - before, syncs)
    assert all(w[0] == w[1] for w in got.values()), got
    assert got["dollar_bar_indexer_q"][1] == 2 and got["bar_products_final"][1] == 1
    assert got["cusum_filter"][1] == 1             # kernel Z's count


def _event_calls(dev):
    """The five event indexers as the bar kits call them, on 300,000 trades
    of the synthetic month on the card: kernel E for volume, CUSUM,
    imbalance and run, the closed form for ticks."""
    from finmlkit_tpu_torch import interop
    from finmlkit_tpu_torch.bar.indexers import (cusum_bar_indexer, imbalance_bar_indexer,
                                                  run_bar_indexer, tick_bar_indexer,
                                                  volume_bar_indexer_q)
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    ts, price, amount, side = bench_trades(300_000, 3)
    tr = interop.from_numpy(quantize_trades(price, amount), None, side, amount, dev,
                            timestamps=ts)
    sigma = torch.full((len(ts),), 2e-5, dtype=torch.float64, device=dev)
    prices = tr.ticks.to(torch.float64) / (1.0 / tr.tick_size)
    return {
        "tick_bar_indexer": lambda: tick_bar_indexer(tr.timestamps, 1000),
        "volume_bar_indexer_q": lambda: volume_bar_indexer_q(tr.timestamps, tr.units, 0.5,
                                                             tr.amount_scale),
        "cusum_bar_indexer": lambda: cusum_bar_indexer(tr.timestamps, prices, sigma, 1e-9,
                                                       20.0),
        "imbalance_bar_indexer": lambda: imbalance_bar_indexer(tr.timestamps, tr.sides,
                                                               threshold=30.0),
        "run_bar_indexer": lambda: run_bar_indexer(
            tr.timestamps, tr.sides, expected_ticks_init=1000.0, expected_rate_init=0.5,
            alpha_ticks=0.05, alpha_rate=0.05),
    }


# the volume index reads its total, the CUSUM index its first valid sigma,
# and each index on kernel E reads E's count once
EVENT_CARD_READS = {"tick_bar_indexer": 0, "volume_bar_indexer_q": 2, "cusum_bar_indexer": 2,
                    "imbalance_bar_indexer": 1, "run_bar_indexer": 1}


def test_every_sync_of_an_event_indexer_is_a_counted_read(cuda):
    """As ``test_every_sync_of_an_entry_is_a_counted_read``, for the event
    indexers, whose buffers never fill here."""
    import warnings
    got = {}
    for name, call in _event_calls(cuda).items():
        call()
        torch.cuda.synchronize()
        before = trace.report().get(name, {}).get("reads", 0)
        regrow = trace.counter("event_scan.regrow")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = [f"{w.filename}:{w.lineno}" for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        got[name] = (len(syncs), trace.report()[name]["reads"] - before, syncs)
        assert trace.counter("event_scan.regrow") == regrow
    assert {k: v[1] for k, v in got.items()} == EVENT_CARD_READS, got
    assert all(w[0] == w[1] for w in got.values()), got


@pytest.mark.parametrize("name", ["cusum_bar_indexer", "imbalance_bar_indexer",
                                  "run_bar_indexer"])
def test_a_full_close_buffer_regrows_on_the_card(cuda, name, monkeypatch):
    """A close buffer of 4 fills: each launch of kernel E again counts one
    ``event_scan.regrow`` and one read, and the closes are those of a
    buffer that never fills."""
    from finmlkit_tpu_torch.bar import indexers
    call = _event_calls(cuda)[name]
    want = call()[1]
    bars = want.shape[0] - 1
    grown = sum(4 ** k <= bars for k in range(1, 12))   # buffers of 4, 16, 64, ... that fill
    monkeypatch.setattr(indexers, "_FIRST_BUFFER", 4)
    regrow, launches = trace.counter("event_scan.regrow"), trace.counter("launch.E")
    reads = trace.report()[name]["reads"]
    got = call()[1]
    assert torch.equal(got, want)
    assert grown >= 1
    assert trace.counter("event_scan.regrow") - regrow == grown
    assert trace.counter("launch.E") - launches == grown + 1
    assert trace.report()[name]["reads"] - reads == EVENT_CARD_READS[name] + grown


# --- kernel Z: the CUSUM filter against the host loop, event for event ---------

MONTH_TRADES = 39_171_929


def _month_prices(seed):
    return bench_trades(MONTH_TRADES, seed)[:2]


def _closes(ts, price):
    """The last price of each minute with trades: the 1-minute bars' closes."""
    minute = (ts - ts[0]) // 60_000_000_000
    return price[np.append(np.flatnonzero(np.diff(minute)), len(price) - 1)]


def _filter_both(x, thr, cuda):
    """Kernel Z's events (a list) and the host loop's on the same values, with
    kernel Z's launches and rounds in the call."""
    x = torch.as_tensor(x, dtype=torch.float64)
    before = (trace.counter("launch.Z"), trace.counter("cusum_filter.rounds"))
    card_thr = thr.to(cuda) if torch.is_tensor(thr) else thr
    got = cusum_filter(x.to(cuda), card_thr)
    assert got.device.type == "cuda" and got.dtype == torch.int64
    launches = trace.counter("launch.Z") - before[0]
    rounds = trace.counter("cusum_filter.rounds") - before[1]
    with np.errstate(divide="ignore", invalid="ignore"):
        want = cusum_filter(x, thr.cpu() if torch.is_tensor(thr) else thr)
    return got.cpu().tolist(), want.tolist(), launches, rounds


def test_cusum_filter_on_the_pass_closes(cuda):
    """The closes of the benchmark's pass on 300,000 trades (time bars and
    products on the card), at the time cell's threshold."""
    from finmlkit_tpu_torch import interop
    from finmlkit_tpu_torch.bar.fused import bar_products_final
    from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
    from finmlkit_tpu_torch.bar.quantize import quantize_trades
    ts, price, amount, side = bench_trades(300_000, 3)
    tr = interop.from_numpy(quantize_trades(price, amount), None, side, amount, cuda,
                            timestamps=ts)
    _, ci = time_bar_indexer(tr.timestamps, 60.0, ts_first=int(ts[0]), ts_last_i=int(ts[-1]))
    close = bar_products_final(tr.ticks, tr.units, ci, tr.sides, tick_size=tr.tick_size,
                               amount_scale=tr.amount_scale, amounts_f32=tr.amounts)[0]["close"]
    for thr in ([0.002], 0.0005):
        got, want, launches, _ = _filter_both(close.cpu(), thr, cuda)
        assert got == want and launches == 1 and len(want) > 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cusum_filter_on_the_month_closes(cuda, seed):
    """The month's 1-minute closes (about 45,700) at the time cell's
    threshold, and at a tenth of it; prints how many of kernel Z's log
    returns differ bitwise from numpy's (one ulp may; not asserted)."""
    from finmlkit_tpu_torch.sampling import filters
    close = _closes(*_month_prices(seed))
    for thr in ([0.002], 0.0002):
        got, want, launches, rounds = _filter_both(close, thr, cuda)
        assert got == want and launches == 1 and len(want) > 100
        print(f"seed {seed}, threshold {thr}: {len(close):,} closes, {len(want):,} "
              f"events, {rounds} rounds")
    x = torch.from_numpy(close).to(cuda)
    r = filters._kernel(x, torch.full((1,), 0.002, dtype=torch.float64, device=cuda))[2]
    host = np.log(close[1:] / close[:-1])
    differ = int((r.cpu().numpy().view(np.int64) != host.view(np.int64)).sum())
    print(f"seed {seed}: {differ} of {len(host):,} log returns differ bitwise from numpy's")


@pytest.mark.parametrize("bad", ["nan", "zero"])
def test_cusum_filter_on_r11_series(cuda, bad):
    """R11's pin on the card: a NaN or a zero price at index 1000 of 6,000,
    threshold 6e-3: 703 and 705 events, the last at 5990."""
    p = 100.0 * np.exp(np.cumsum(np.random.default_rng(0).normal(0.0, 2e-3, 6000)))
    p[1000] = np.nan if bad == "nan" else 0.0
    got, want, launches, _ = _filter_both(p, [6e-3], cuda)
    assert got == want and launches == 1
    assert (len(got), got[-1]) == {"nan": (703, 5990), "zero": (705, 5990)}[bad]


@pytest.mark.parametrize("form", ["cuda", "numpy", "cpu"])
def test_cusum_filter_per_sample_thresholds(cuda, form):
    """One threshold a close: a CUDA tensor (used in place), a numpy array
    and a CPU tensor (copied from pinned memory)."""
    close = _closes(*bench_trades(3_000_000, 4)[:2])
    thr = 0.002 * np.random.default_rng(5).uniform(0.25, 1.75, len(close))
    thr = np.asarray(thr) if form == "numpy" else torch.from_numpy(thr)
    got, want, launches, _ = _filter_both(close, thr.to(cuda) if form == "cuda" else thr, cuda)
    assert got == want and launches == 1 and len(want) > 10


@pytest.mark.parametrize("n", [2, 3, 100, 1023, 1024, 1025, 2049])
def test_cusum_filter_short_series(cuda, n):
    """Fewer values than walkers, and about as many."""
    p = 100.0 * np.exp(np.cumsum(np.random.default_rng(n).normal(0.0, 2e-3, n)))
    got, want, launches, rounds = _filter_both(p, [2e-3], cuda)
    assert got == want and launches == 1 and rounds >= 1
    if n == 2:
        assert _filter_both([1.0, 2.0], 0.5, cuda)[:2] == ([1], [1])


def test_cusum_filter_walks_that_never_meet(cuda):
    """A rising series under a threshold no sum reaches: no walk meets its
    predecessor's, so the rounds are one a walker (1,024)."""
    got, want, launches, rounds = _filter_both(np.arange(1.0, 1026.0), [10.0], cuda)
    assert got == want == [] and launches == 1 and rounds == 1024


def test_cusum_filter_checks_lengths_without_a_read(cuda):
    x = torch.ones(10, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="at least 2"):
        cusum_filter(x[:1], [0.1])
    with pytest.raises(ValueError, match="Threshold array"):
        cusum_filter(x, torch.full((3,), 0.1, dtype=torch.float64, device=cuda))


def test_cusum_filter_on_the_month_prices(cuda):
    """Every trade price of a month (39,171,929 values; about 38,000 returns a
    walker)."""
    price = _month_prices(6)[1]
    got, want, launches, rounds = _filter_both(price, [5e-4], cuda)
    assert got == want and launches == 1 and len(want) > 1000
    print(f"month prices: {len(want):,} events, {rounds} rounds")
