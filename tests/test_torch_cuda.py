"""Kernels B, S, C, F, E, H, V, P, R, W and G on the card against their plain
versions.

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
from finmlkit_tpu_torch.ops import event_scan, fused_scan, prefix_scan, scan, segment_hist
from finmlkit_tpu_torch.testing import (CSW_FILTER_CASES, CUSUM_BAD, PROFILE_CASES,
                                       PROFILE_EXTRA_CASES,
                                       PROFILE_ROW_CASES, PROFILE_TS, PROFILE_WINDOW,
                                       TILE_CLOSES, adversarial_trades, assert_close,
                                       assert_exact, assert_window_close, cusum_bad_inputs,
                                       csw_filter_case, cusum_recurrence, profile_case,
                                       profile_rows_case, tile_closes, zeros_and_twos)

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
    before = (prefix_scan.LAUNCHES, prefix_scan.FLOAT_LAUNCHES)
    got = prefix_scan.fast_cumsum(x)
    assert (prefix_scan.LAUNCHES, prefix_scan.FLOAT_LAUNCHES) == \
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
    before = fused_scan.LAUNCHES
    got = fused_scan.bar_scan_products(ticks, units, sides, ci)
    assert fused_scan.LAUNCHES == before + 1
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
    before = fused_scan.LAUNCHES
    got = fused_scan.bar_scan_products(ticks, units, sides, ci)
    assert fused_scan.LAUNCHES == before + 1
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
    before = prefix_scan.COLS_LAUNCHES
    got = prefix_scan.fast_cumsum_cols(x)
    assert prefix_scan.COLS_LAUNCHES == before + 1
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
    before = prefix_scan.LAUNCHES
    _, dci = dollar_bar_indexer_q(ts, ticks, small, 5e4, 0.1, 1e-8)
    assert prefix_scan.LAUNCHES == before + 1
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
    before = prefix_scan.COLS_LAUNCHES
    got = comp_bar_footprints_q(ticks, amounts, ci, sides, low, high, 3.0,
                                max_levels=L)
    assert prefix_scan.COLS_LAUNCHES == before + 1
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
    before = prefix_scan.FFILL_LAUNCHES
    got = prefix_scan.fast_ffill(v, m)
    assert prefix_scan.FFILL_LAUNCHES == before + 1
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
    before = (event_scan.LAUNCHES, prefix_scan.LAUNCHES)
    got = event_scan.info_scan(w, *args, mb, run_mode)
    assert (event_scan.LAUNCHES, prefix_scan.LAUNCHES) == \
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
    before = (event_scan.LAUNCHES, prefix_scan.LAUNCHES)
    got = event_scan.volume_scan(units, thr, mb)
    assert (event_scan.LAUNCHES, prefix_scan.LAUNCHES) == \
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
    before = (event_scan.LAUNCHES, prefix_scan.LAUNCHES)
    got = event_scan.cusum_scan(rets, lam, can_close, start, mb)
    assert (event_scan.LAUNCHES, prefix_scan.LAUNCHES) == \
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
        before = list(event_scan.MODE_LAUNCHES)
        got = event_scan.info_scan(w, 1.0, theta, 0.0, 0.0, mb, False)
        assert event_scan.MODE_LAUNCHES[event_scan._IMBALANCE_MAP] == \
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
    before = list(event_scan.MODE_LAUNCHES)
    got = event_scan.info_scan(w, *args, n, False)
    assert [a - b for a, b in zip(event_scan.MODE_LAUNCHES, before)] == [0, 1, 0, 0, 0]
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
        before = segment_hist.LAUNCHES
        got = segment_hist.hist_pass(bits, ci, base, s)
        assert segment_hist.LAUNCHES == before + 1
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
    counters = (segment_hist.LAUNCHES, prefix_scan.FILL_LAST_LAUNCHES)
    got = median_engine(engine)(amounts, ci)
    launched = (segment_hist.LAUNCHES - counters[0],
                prefix_scan.FILL_LAST_LAUNCHES - counters[1])
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
    before = prefix_scan.FILL_LAST_LAUNCHES
    got = prefix_scan.fill_last(v, m)
    assert prefix_scan.FILL_LAST_LAUNCHES == before + 1
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
    before = (fused_scan.PLANES_LAUNCHES, prefix_scan.COLS_LAUNCHES)
    got = fused_scan.bar_scan_planes(ticks, units, sides, ci)
    assert (fused_scan.PLANES_LAUNCHES, prefix_scan.COLS_LAUNCHES) == \
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
    before = fused_scan.IO_FLOOR_LAUNCHES
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
    assert fused_scan.IO_FLOOR_LAUNCHES == before + 9


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
    before = scan.LAUNCHES
    got = scan.linear_recurrence(a, b, y0=y0)
    assert scan.LAUNCHES == before + 1
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
    before = structural_break.LAUNCHES
    got = structural_break._sup_stat(y, sigma, w, *tables)
    assert structural_break.LAUNCHES == before + 1
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
    before = volume.LAUNCHES
    got = volume._rolling(start, first, low, nl, buy, sell, m, n_bins, 0.6834,
                          shared_cap=0 if path == "global" else None)
    assert volume.LAUNCHES == before + 3     # the pool's slots, the profiles, the walks
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
    before = volume.LAUNCHES
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
    assert volume.LAUNCHES > before
    for g_, w, what in zip(got, want, ("poc", "hva", "lva", "pct")):
        assert_exact(g_, w, f"{mode} {name} bins {n_bins} va {va_pct} {path} {what}")

