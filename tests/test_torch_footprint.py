"""Footprints of finmlkit_tpu_torch (``bar/footprint.py``, ``bar/footprint_q.py``,
plain path of kernel C) against the JAX package on the CPU.

- The features of dense grids, on the scenarios of
  ``tests/bars/test_footprint_scenarios.py`` (diagonal semantics, strict
  thresholds, edge levels, runs and their ties, COT ties and edges, skew and
  gini), against ``footprint_features_from_tensors`` and the scenarios' own
  expected values.
- Dense footprints from trades, against the f64 path ``comp_bar_footprints``:
  levels, ticks, flags, runs and COT exact; volumes bit-exact (both sum the
  float64 amounts of a cell in trade order and round once); ``vp_skew`` and
  ``vp_gini`` within 1e-9 absolute (sums over the levels in another order;
  ``vp_skew`` is the first moment about its own mean, i.e. rounding noise of
  absolute levels near 1e3-1e6). Against ``comp_bar_footprints_q`` with the
  JAX package's own tolerances (``tests/bars/test_footprint.py``), except the
  cases of ROADMAP faults R1 (a cell of 2^15 or more sells) and R6 (a trailing
  empty bar), which pin the ``_q`` path's wrong values instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar.footprint import comp_bar_footprints
from finmlkit_tpu.bar.footprint import footprint_features_from_tensors as jax_features
from finmlkit_tpu.bar.footprint_q import comp_bar_footprints_q as jax_fp_q
from finmlkit_tpu.ops.scan import next_bucket
from finmlkit_tpu_torch.bar.footprint import footprint_features_from_tensors
from finmlkit_tpu_torch.bar.footprint_q import bar_footprints, comp_bar_footprints_q
from finmlkit_tpu_torch.ops import prefix_scan
from finmlkit_tpu_torch.testing import assert_close, assert_exact

VP_ATOL = 1e-9
VP_KEYS = ("vp_skew", "vp_gini")


def _compare(got, want, what=""):
    """Every output exact, except vp_skew and vp_gini (1e-9 absolute)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        w = np.asarray(w)
        if k in VP_KEYS:
            assert got[k].dtype == torch.float64
            assert_close(got[k], w, rtol=0.0, atol=VP_ATOL, what=f"{what} {k}")
        else:
            assert_exact(got[k], w, f"{what} {k}")


# --- features of dense grids: the scenario matrix -------------------------

PAD_BARS, PAD_L = 24, 8  # one JAX compile for every scenario


def _scenario(buy, sell, low=None, mult=3.0, **expect):
    return dict(buy=buy, sell=sell, low=low, mult=mult, expect=expect)


_R = np.random.default_rng(5)
SCENARIOS = {
    "single_level": _scenario([[10.0]], [[10.0]], buy_imbalances_sum=[0],
                              sell_imbalances_sum=[0], imb_max_run_signed=[0]),
    "buy_diagonal": _scenario([[0.0, 31.0]], [[10.0, 0.0]],
                              buy_imbalances=[[False, True]],
                              sell_imbalances=[[False, False]]),
    "buy_at_threshold": _scenario([[0.0, 30.0]], [[10.0, 0.0]],
                                  buy_imbalances_sum=[0]),
    "sell_diagonal": _scenario([[0.0, 5.0]], [[16.0, 0.0]],
                               sell_imbalances=[[True, False]],
                               buy_imbalances=[[False, False]]),
    "zero_volume_pairs": _scenario([[0.0] * 3], [[0.0] * 3],
                                   buy_imbalances_sum=[0], sell_imbalances_sum=[0]),
    "zero_sell_any_buy": _scenario([[0.0, 1.0]], [[0.0, 0.0]],
                                   buy_imbalances=[[False, True]]),
    "edge_levels": _scenario([[100.0, 0.0, 0.0]], [[0.0, 0.0, 100.0]], mult=1.0,
                             buy_imbalances=[[False, False, False]],
                             sell_imbalances=[[False, False, False]]),
    "counts_sum": _scenario([[0.0, 40.0, 0.0, 50.0]], [[10.0, 0.0, 10.0, 0.0]],
                            buy_imbalances_sum=[2], sell_imbalances_sum=[0]),
    "run_one_buy": _scenario([[0.0, 40.0]], [[10.0, 0.0]], imb_max_run_signed=[1]),
    "run_two_buys": _scenario([[0.0, 40.0, 40.0]], [[10.0, 10.0, 0.0]],
                              imb_max_run_signed=[2]),
    "run_none": _scenario([[1.0] * 3], [[1.0] * 3], imb_max_run_signed=[0]),
    "run_alternating": _scenario([[0.0, 40.0, 0.0, 40.0]], [[10.0, 0.0, 200.0, 0.0]],
                                 imb_max_run_signed=[1]),
    "run_long_sell": _scenario([[0.0, 1.0, 1.0, 1.0, 1.0]],
                               [[50.0, 50.0, 50.0, 50.0, 0.0]],
                               imb_max_run_signed=[-4]),
    "run_longer_later": _scenario([[0.0, 40.0, 0.0, 1.0, 1.0, 1.0]],
                                  [[10.0, 0.0, 50.0, 50.0, 50.0, 0.0]],
                                  imb_max_run_signed=[-3]),
    "run_tie_keeps_first": _scenario([[0.0, 40.0, 40.0, 0.0, 0.0, 1.0]],
                                     [[10.0, 10.0, 0.0, 50.0, 50.0, 0.0]],
                                     imb_max_run_signed=[2]),
    "cot_clear": _scenario([[1.0, 10.0, 1.0]], [[1.0, 10.0, 1.0]], low=[500],
                           cot_price_levels=[501]),
    "cot_tie_first": _scenario([[5.0, 1.0, 5.0]], [[5.0, 1.0, 5.0]], low=[300],
                               cot_price_levels=[300]),
    "cot_top_level": _scenario([[1.0, 1.0, 99.0]], [[0.0] * 3], low=[100],
                               cot_price_levels=[102]),
    "cot_zero_volume": _scenario([[0.0, 0.0]], [[0.0, 0.0]], low=[700],
                                 cot_price_levels=[700]),
    "skew_symmetric": _scenario([[5.0, 0.0, 5.0]], [[5.0, 0.0, 5.0]], vp_skew=[0.0]),
    "skew_single_level": _scenario([[42.0]], [[13.0]], vp_skew=[0.0]),
    "skew_first_moment_a": _scenario([[1.0, 1.0, 50.0]], [[0.0] * 3], vp_skew=[0.0]),
    "skew_first_moment_b": _scenario([[50.0, 1.0, 1.0]], [[0.0] * 3], vp_skew=[0.0]),
    "skew_first_moment_c": _scenario([[1.0, 0.0, 0.0, 0.0, 50.0]], [[0.0] * 5],
                                     vp_skew=[0.0]),
    "gini_uniform": _scenario([[2.5] * 4], [[0.0] * 4], vp_gini=[1.0 - 4 * 0.25**2]),
    "gini_concentrated": _scenario([[0.0, 100.0, 0.0]], [[0.0] * 3], vp_gini=[0.0]),
    "gini_merged_a": _scenario([[3.0, 1.0]], [[0.0, 2.0]], vp_gini=[0.5]),
    "gini_merged_b": _scenario([[0.0, 0.0]], [[3.0, 3.0]], vp_gini=[0.5]),
    "zero_volume_bar": _scenario([[0.0, 0.0]], [[0.0, 0.0]], vp_gini=[0.0],
                                 vp_skew=[0.0]),
    "multi_bar": _scenario([[0.0, 40.0, 40.0, 0.0], [0.0] * 4, [1.0] * 4],
                           [[10.0, 10.0, 0.0, 0.0], [0.0] * 4, [1.0] * 4],
                           low=[10, 20, 30], imb_max_run_signed=[2, 0, 0],
                           cot_price_levels=[11, 20, 30]),
    "random_bars": _scenario(_R.random((20, 6)).astype(np.float32),
                             _R.random((20, 6)).astype(np.float32)),
}


def _padded(sc):
    buy = np.atleast_2d(np.asarray(sc["buy"], np.float32))
    sell = np.atleast_2d(np.asarray(sc["sell"], np.float32))
    nb, L = buy.shape
    bv = np.zeros((PAD_BARS, PAD_L), np.float32)
    sv = np.zeros((PAD_BARS, PAD_L), np.float32)
    bv[:nb, :L], sv[:nb, :L] = buy, sell
    low = np.full(PAD_BARS, 200, np.int32)
    if sc["low"] is not None:
        low[:nb] = sc["low"]
    n_levels = np.full(PAD_BARS, L, np.int32)
    ticks = np.ones((PAD_BARS, PAD_L), np.int32)
    return nb, L, (low, n_levels, bv, sv, ticks, ticks.copy())


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_features_scenarios(name):
    sc = SCENARIOS[name]
    nb, L, args = _padded(sc)
    want = {k: np.asarray(v) for k, v in
            jax_features(*(jnp.asarray(a) for a in args), sc["mult"]).items()}
    got = footprint_features_from_tensors(*(torch.from_numpy(a) for a in args),
                                          sc["mult"])
    _compare(got, want, name)
    for k, v in sc["expect"].items():
        g = got[k][:nb].numpy()
        if g.ndim == 2:
            g = g[:, :L]
        if k in VP_KEYS:
            np.testing.assert_allclose(g, v, rtol=1e-6, atol=1e-10, err_msg=k)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)
    g = got["vp_gini"][:nb].numpy()
    assert np.all(g >= -1e-9) and np.all(g < 1.0)


# --- dense footprints from trades ------------------------------------------

TICK = 0.5
N_TRADES = 6000
CASES = ["regular", "empty_and_single", "first_after_0", "narrow_levels",
         "trailing_empty"]


def _trades(case, seed):
    g = np.random.default_rng(seed)
    n = N_TRADES
    ticks = (20_000 + np.cumsum(g.integers(-2, 3, n))).astype(np.int32)
    amounts = np.maximum(np.round(g.lognormal(-3.0, 1.5, n), 5), 1e-5).astype(np.float32)
    sides = g.choice(np.array([-1, 0, 1], np.int8), n, p=[0.45, 0.1, 0.45])
    first = 37 if case == "first_after_0" else -1
    end = n - 1 if case == "trailing_empty" else n - 50  # trailing trades
    ci, pos = [first], first
    while pos < end:
        u = g.random()
        if case == "empty_and_single" and u < 0.15:
            pos += 1 if u < 0.08 else 0          # single-trade or empty bar
        else:
            pos += int(g.geometric(1 / 60))
        pos = min(pos, end)
        ci.append(pos)
    if case == "trailing_empty":
        ci.append(n - 1)                         # starts at n, clipped to n-1
    ci = np.asarray(ci, np.int64)
    starts, closes = ci[:-1] + 1, ci[1:]
    low = np.array([ticks[s:e + 1].min() if e >= s else ticks[min(e, n - 1)]
                    for s, e in zip(starts, closes)], np.int32)
    high = np.array([ticks[s:e + 1].max() if e >= s else ticks[min(e, n - 1)]
                     for s, e in zip(starts, closes)], np.int32)
    if case == "trailing_empty":
        # trade n-1 above the low of its bar, so that R6 moves it
        ticks[n - 1] = low[-2] + 1
        high[-2] = max(high[-2], ticks[n - 1])
        low[-1] = high[-1] = ticks[n - 1]
    if case == "narrow_levels":  # levels outside [low, high] drop their trades
        low[::3] += 1
        high[1::3] -= 1
        high = np.maximum(high, low)
    return ticks, amounts, sides, ci, low, high


@pytest.fixture(scope="module", params=CASES)
def fp_case(request):
    case = request.param
    ticks, amounts, sides, ci, low, high = _trades(case, CASES.index(case))
    L = next_bucket(int((high - low + 1).max()), 8)
    f64 = comp_bar_footprints(
        jnp.asarray(ticks.astype(np.float64) * TICK), jnp.asarray(amounts),
        jnp.asarray(ci), jnp.asarray(sides), TICK,
        jnp.asarray(low.astype(np.float64) * TICK),
        jnp.asarray(high.astype(np.float64) * TICK), 3.0, max_levels=L)
    q = jax_fp_q(jnp.asarray(ticks), jnp.asarray(amounts), jnp.asarray(ci),
                 jnp.asarray(sides), jnp.asarray(low), jnp.asarray(high), 3.0,
                 max_levels=L)
    t = [torch.from_numpy(a) for a in (ticks, amounts, ci, sides, low, high)]
    before = prefix_scan.COLS_LAUNCHES
    got = comp_bar_footprints_q(*t, 3.0, max_levels=L)
    assert prefix_scan.COLS_LAUNCHES == before  # CPU tensors: the plain scan
    return dict(case=case, got=got, ci=ci, L=L,
                f64={k: np.asarray(v) for k, v in f64.items()},
                q={k: np.asarray(v) for k, v in q.items()})


def test_footprints_match_f64_path(fp_case):
    _compare(fp_case["got"], fp_case["f64"], fp_case["case"])
    n_bars = len(fp_case["ci"]) - 1
    assert fp_case["got"]["buy_volumes"].shape == (n_bars, fp_case["L"])
    assert int(fp_case["got"]["buy_ticks"].sum() + fp_case["got"]["sell_ticks"].sum()) > 0


def test_footprints_match_q_path(fp_case):
    got, q = fp_case["got"], fp_case["q"]
    rows = np.arange(len(fp_case["ci"]) - 1)
    if fp_case["case"] == "trailing_empty":
        # R6: the _q path moves trade n-1 of the last real bar to level 0
        last = rows[-2]
        assert not np.array_equal(got["buy_ticks"][last] + got["sell_ticks"][last],
                                  q["buy_ticks"][last] + q["sell_ticks"][last])
        rows = rows[rows != last]
    for k in ("low_level", "n_levels", "buy_ticks", "sell_ticks",
              "buy_imbalances", "imb_max_run_signed", "cot_price_levels"):
        np.testing.assert_array_equal(got[k].numpy()[rows], np.asarray(q[k])[rows],
                                      err_msg=k)
    for k in ("buy_volumes", "sell_volumes"):
        np.testing.assert_allclose(got[k].numpy()[rows], q[k][rows], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["vp_skew"].numpy()[rows], q["vp_skew"][rows],
                               atol=2e-4)
    np.testing.assert_allclose(got["vp_gini"].numpy()[rows], q["vp_gini"][rows],
                               atol=2e-5)


def test_r1_many_sells_in_one_cell():
    # ROADMAP R1: 40,000 sells at one level of one bar
    n = 40_000
    ticks = np.full(n, 1000, np.int32)
    amounts = np.full(n, 0.5, np.float32)
    sides = np.full(n, -1, np.int8)
    ci = np.array([-1, n - 1], np.int64)
    low = high = np.array([1000], np.int32)
    got = comp_bar_footprints_q(*(torch.from_numpy(a) for a in
                                  (ticks, amounts, ci, sides, low, high)),
                                3.0, max_levels=8)
    f64 = comp_bar_footprints(
        jnp.asarray(ticks * 1.0), jnp.asarray(amounts), jnp.asarray(ci),
        jnp.asarray(sides), 1.0, jnp.asarray(low * 1.0), jnp.asarray(high * 1.0),
        3.0, max_levels=8)
    q = jax_fp_q(jnp.asarray(ticks), jnp.asarray(amounts), jnp.asarray(ci),
                 jnp.asarray(sides), jnp.asarray(low), jnp.asarray(high), 3.0,
                 max_levels=8)
    assert int(got["sell_ticks"][0, 0]) == 40_000
    assert int(np.asarray(f64["sell_ticks"])[0, 0]) == 40_000
    assert int(np.asarray(q["sell_ticks"])[0, 0]) == -25_536
    assert float(got["sell_volumes"][0, 0]) == 20_000.0


@pytest.mark.parametrize("ratio", [1, 2, 5])
def test_bar_footprints_refines_the_tick_grid(ratio):
    ticks, amounts, sides, ci, low, high = _trades("regular", 7)
    ohlcv = {"low": torch.from_numpy(low.astype(np.float64) * TICK),
             "high": torch.from_numpy(high.astype(np.float64) * TICK)}
    fine = TICK / ratio
    got = bar_footprints(torch.from_numpy(ticks), torch.from_numpy(amounts),
                         torch.from_numpy(ci), torch.from_numpy(sides), ohlcv,
                         tick_size=TICK, price_tick_size=fine)
    L = next_bucket(int(((high - low) * ratio + 1).max()), 8)
    want = comp_bar_footprints(
        jnp.asarray(ticks.astype(np.float64) * TICK), jnp.asarray(amounts),
        jnp.asarray(ci), jnp.asarray(sides), fine,
        jnp.asarray(low.astype(np.float64) * TICK),
        jnp.asarray(high.astype(np.float64) * TICK), 3.0, max_levels=L)
    _compare(got, {k: np.asarray(v) for k, v in want.items()}, f"ratio {ratio}")


def test_bar_footprints_rejects_int32_overflow():
    # the bar's ticks fit int32 on the finer grid; the trailing trade's do not
    ticks = torch.tensor([100, 101, 102, 2**29], dtype=torch.int32)
    ohlcv = {"low": torch.tensor([100.0], dtype=torch.float64),
             "high": torch.tensor([102.0], dtype=torch.float64)}
    args = (ticks, torch.ones(4, dtype=torch.float32),
            torch.tensor([-1, 2], dtype=torch.int64),
            torch.tensor([1, -1, 1, 1], dtype=torch.int8), ohlcv)
    got = bar_footprints(*args, tick_size=1.0, price_tick_size=0.5)
    assert got["low_level"].tolist() == [200] and got["n_levels"].tolist() == [5]
    with pytest.raises(ValueError, match="overflow"):
        bar_footprints(*args, tick_size=1.0, price_tick_size=0.25)


def test_bar_footprints_rejects_irregular_grid():
    ticks, amounts, sides, ci, low, high = _trades("regular", 7)
    ohlcv = {"low": torch.from_numpy(low * TICK), "high": torch.from_numpy(high * TICK)}
    with pytest.raises(ValueError):
        bar_footprints(torch.from_numpy(ticks), torch.from_numpy(amounts),
                       torch.from_numpy(ci), torch.from_numpy(sides), ohlcv,
                       tick_size=TICK, price_tick_size=0.3)
