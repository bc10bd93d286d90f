"""The information-driven bar indexers of finmlkit_tpu_torch (the plain paths
of kernel E and the closed-form tick indexer) against the JAX package on
XLA:CPU, and each plain scan of ``ops/event_scan.py`` against a sequential
emulation in Python.

Close indices must be exact: tick bars, integer volume bars (also against the
host loop of ``finmlkit_tpu/native/seg_stats.cpp:183-194``), CUSUM bars with
the cases of ``tests/bars/test_indexers.py:148-169`` (their filled sigma
exact as well), and imbalance and run bars in tick, volume and dollar mode,
with fixed and EMA thresholds. The float64 sums are taken in another order
than XLA's; the data hold no statistic within rounding of a threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar import indexers as jidx
from finmlkit_tpu.bar.quantize import quantize_trades as jax_quantize_trades
from finmlkit_tpu_torch.bar import indexers
from finmlkit_tpu_torch.ops import event_scan
from finmlkit_tpu_torch.testing import assert_exact
from tests.conftest import generate_trades

N = 6000


@pytest.fixture(scope="module")
def trades():
    return generate_trades(n=N, seed=11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# tick and volume bars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("thr", [0, 1, 2, 1000])
def test_tick_bars_match_jax(trades, thr):
    ts = trades[0]
    want_ts, want = jidx.tick_bar_indexer(jnp.asarray(ts), thr)
    got_ts, got = indexers.tick_bar_indexer(_t(ts), thr)
    assert_exact(got, np.asarray(want), "ci")
    assert_exact(got_ts, np.asarray(want_ts), "close_ts")


def _volume_sequential(units, thr_units):
    """The host loop of seg_stats.cpp:183-194 on integer units."""
    out, cum = [0], int(units[0])
    for i in range(1, len(units)):
        cum += int(units[i])
        if cum >= thr_units:
            out.append(i)
            cum = 0
    return np.array(out, np.int64)


@pytest.mark.parametrize("thr", [0.3, 1.0, 5.0, 1e-9, 1e6])
def test_volume_bars_q_match_jax_and_loop(trades, thr):
    ts, px, amt, _ = trades
    q = jax_quantize_trades(px, amt)
    want_ts, want = jidx.volume_bar_indexer_q(
        jnp.asarray(ts), jnp.asarray(q.amount_units), thr, q.amount_scale)
    got_ts, got = indexers.volume_bar_indexer_q(_t(ts), _t(q.amount_units), thr,
                                                q.amount_scale)
    assert_exact(got, np.asarray(want), "ci")
    assert_exact(got_ts, np.asarray(want_ts), "close_ts")
    assert_exact(got, _volume_sequential(q.amount_units, thr / q.amount_scale),
                 "ci vs the host loop")


# ---------------------------------------------------------------------------
# CUSUM bars
# ---------------------------------------------------------------------------

def _cusum_case(name, trades):
    ts, px, _, _ = trades
    if name == "same_timestamp_block":     # test_indexers.py:160-169
        ts = np.array([0, 1, 1, 1, 2, 3], np.int64)
        px = np.array([100.0, 100.0, 110.0, 110.0, 110.0, 110.0])
        return ts, px, np.full(6, 1e-3), 1e-4, 2.0
    sigma = np.full(len(px), 5e-4)
    if name == "nan_sigma":                # test_indexers.py:148-158
        sigma[:50] = np.nan
        sigma[200:220] = np.nan
    elif name == "varying_sigma":
        r = np.random.default_rng(3)
        sigma = r.uniform(1e-4, 8e-4, len(px))
        sigma[r.random(len(px)) < 0.05] = np.nan
    elif name == "all_nan_sigma":
        sigma[:] = np.nan
    return ts, px, sigma, 1e-4, 2.0


CUSUM_CASES = ["same_timestamp_block", "nan_sigma", "varying_sigma",
               "all_nan_sigma", "floor_only"]


@pytest.mark.parametrize("name", CUSUM_CASES)
def test_cusum_bars_match_jax(trades, name):
    ts, px, sigma, floor, mult = _cusum_case(name, trades)
    if name == "floor_only":
        floor = 2e-3
    want_ts, want, want_sig = jidx.cusum_bar_indexer(
        jnp.asarray(ts), jnp.asarray(px), jnp.asarray(sigma), floor, mult)
    got_ts, got, got_sig = indexers.cusum_bar_indexer(
        _t(ts), _t(px), _t(sigma), floor, mult)
    assert_exact(got, np.asarray(want), "ci")
    assert_exact(got_ts, np.asarray(want_ts), "close_ts")
    assert_exact(got_sig, np.asarray(want_sig), "filled sigma")
    if name not in ("all_nan_sigma", "same_timestamp_block"):
        assert len(want) > 3


def test_cusum_max_bars_truncates(trades):
    ts, px, sigma, floor, mult = _cusum_case("nan_sigma", trades)
    _, full, _ = indexers.cusum_bar_indexer(_t(ts), _t(px), _t(sigma), floor, mult)
    _, cut, _ = indexers.cusum_bar_indexer(_t(ts), _t(px), _t(sigma), floor, mult,
                                           max_bars=10)
    assert len(full) > 11
    assert_exact(cut, full[:11], "ci[:max_bars + 1]")


# ---------------------------------------------------------------------------
# imbalance and run bars
# ---------------------------------------------------------------------------

def _weights(mode, trades):
    _, px, amt, _ = trades
    if mode == "tick":
        return None
    if mode == "volume":
        return amt
    return px * amt.astype(np.float64)


# (mode, fixed threshold, EMA: E0[T], E0[rate] per unit weight, alphas)
INFO_CASES = {
    "tick_fixed": ("tick", dict(threshold=17.0)),
    "tick_ema": ("tick", dict(expected_ticks_init=50.0, expected_rate_init=0.3,
                              alpha_ticks=0.1, alpha_rate=0.05)),
    "volume_fixed": ("volume", dict(threshold=1.5)),
    "volume_ema": ("volume", dict(expected_ticks_init=50.0,
                                  expected_rate_init=0.03, alpha_ticks=0.1,
                                  alpha_rate=0.05)),
    "dollar_fixed": ("dollar", dict(threshold=150.0)),
    "dollar_ema": ("dollar", dict(expected_ticks_init=50.0,
                                  expected_rate_init=3.0, alpha_ticks=0.1,
                                  alpha_rate=0.05)),
}


@pytest.mark.parametrize("run_mode", [False, True], ids=["imbalance", "run"])
@pytest.mark.parametrize("case", list(INFO_CASES))
def test_info_bars_match_jax(trades, case, run_mode):
    ts, _, _, side = trades
    mode, kw = INFO_CASES[case]
    w = _weights(mode, trades)
    jf = jidx.run_bar_indexer if run_mode else jidx.imbalance_bar_indexer
    pf = indexers.run_bar_indexer if run_mode else indexers.imbalance_bar_indexer
    want_ts, want = jf(jnp.asarray(ts), jnp.asarray(side),
                       None if w is None else jnp.asarray(w), **kw)
    got_ts, got = pf(_t(ts), _t(side), None if w is None else _t(w), **kw)
    assert_exact(got, np.asarray(want), "ci")
    assert_exact(got_ts, np.asarray(want_ts), "close_ts")
    assert len(want) > 5


@pytest.mark.parametrize("run_mode", [False, True], ids=["imbalance", "run"])
def test_info_runaway_guard_and_max_bars(trades, run_mode):
    pf = indexers.run_bar_indexer if run_mode else indexers.imbalance_bar_indexer
    # theta 1 on tick weights closes a bar at every trade: past the first
    # buffer of 2^16 bars and above n / 8, a ValueError unless capped
    n = 70_000
    side = np.where(np.random.default_rng(8).random(n) < 0.5, 1, -1).astype(np.int8)
    ts = np.arange(n, dtype=np.int64)
    with pytest.raises(ValueError, match="every-trade"):
        pf(_t(ts), _t(side), threshold=1.0)
    _, got = pf(_t(ts), _t(side), threshold=1.0, max_bars=40)
    assert got.tolist() == list(range(41))
    ts, _, _, side = trades
    _, full = pf(_t(ts), _t(side), threshold=17.0)
    _, cut = pf(_t(ts), _t(side), threshold=17.0, max_bars=5)
    assert_exact(cut, full[:6], "ci[:max_bars + 1]")


def test_info_bars_reject_bad_arguments(trades):
    ts, _, _, side = trades
    with pytest.raises(ValueError):
        indexers.imbalance_bar_indexer(_t(ts), _t(side), threshold=10.0,
                                       alpha_ticks=0.1)
    with pytest.raises(ValueError):
        indexers.run_bar_indexer(_t(ts), _t(side), expected_ticks_init=10.0)


# ---------------------------------------------------------------------------
# each plain scan against a sequential emulation
# ---------------------------------------------------------------------------

def _info_sequential(w, e_t, e_r, a_t, a_r, run_mode):
    """tests/bars/test_info_bars.py:17: from trade 1, close at the first
    crossing of theta = e_t * e_r, reset, EMA-update at the close."""
    closes, cb, cs, open_pos = [], 0.0, 0.0, 0
    for i in range(1, len(w)):
        if run_mode:
            cb += w[i] if w[i] > 0 else 0.0
            cs += -w[i] if w[i] < 0 else 0.0
            stat = max(cb, cs)
        else:
            cb += w[i]
            stat = abs(cb)
        if stat >= e_t * e_r:
            closes.append(i)
            t_bar = i - open_pos
            rate = stat / max(t_bar, 1.0)
            e_t = (1 - a_t) * e_t + a_t * t_bar
            e_r = (1 - a_r) * e_r + a_r * rate
            cb = cs = 0.0
            open_pos = i
    return np.array(closes, np.int64)


def _cusum_sequential(rets, lam, can_close, start):
    out, sp, sn = [], 0.0, 0.0
    for i in range(start + 1, len(rets)):
        sp = max(0.0, sp + rets[i])
        sn = min(0.0, sn + rets[i])
        if not can_close[i]:
            continue
        if sp >= lam[i]:
            out.append(i)
            sp = 0.0
        elif sn <= -lam[i]:
            out.append(i)
            sn = 0.0
    return np.array(out, np.int64)


@pytest.mark.parametrize("run_mode", [False, True], ids=["imbalance", "run"])
@pytest.mark.parametrize("weights", ["tick", "volume"])
def test_info_scan_plain_matches_sequential(trades, weights, run_mode):
    _, _, amt, side = trades
    w = side.astype(np.float64) * (1.0 if weights == "tick" else amt.astype(np.float64))
    theta = 17.0 if weights == "tick" else 1.5
    for e_t, e_r, a_t, a_r in ((1.0, theta, 0.0, 0.0),
                               (50.0, theta / 50, 0.1, 0.05)):
        want = _info_sequential(w, e_t, e_r, a_t, a_r, run_mode)
        got = event_scan.info_scan_plain(_t(w), e_t, e_r, a_t, a_r, N, run_mode)
        assert_exact(got, want, f"{weights} {e_t} {run_mode}")
        assert len(want) >= 5


def test_cusum_scan_plain_matches_sequential(trades):
    ts, px, _, _ = trades
    r = np.random.default_rng(5)
    rets = np.concatenate([[0.0], np.diff(np.log(px))])
    lam = np.maximum(2.0 * r.uniform(1e-4, 6e-4, N), 1e-4)
    can_close = np.concatenate([ts[:-1] != ts[1:], [True]])
    # long stretches of small returns, so that chunks hold more than 4 events
    rets[3000:3100] = 1e-3
    for start in (0, 17):
        want = _cusum_sequential(rets, lam, can_close, start)
        got = event_scan.cusum_scan_plain(_t(rets), _t(lam), _t(can_close),
                                          start, N)
        assert_exact(got, want, f"start {start}")
        assert len(want) > 50


@pytest.mark.parametrize("thr", [1, 10**6, 10**8, 10**12])
def test_volume_scan_plain_matches_sequential(thr):
    units = np.random.default_rng(6).integers(0, 10**7, N).astype(np.int64)
    units[::50] = 10**9
    want = _volume_sequential(units, thr)[1:]
    got = event_scan.volume_scan_plain(_t(units), thr, N)
    assert_exact(got, want, f"thr {thr}")
    capped = event_scan.volume_scan_plain(_t(units), thr, 3)
    assert_exact(capped, want[:3], "capped")


def test_volume_threshold_in_units_is_exact():
    # the threshold 2.5 units needs 3 units; 2 units must not close
    ts = np.arange(6, dtype=np.int64)
    units = np.array([1, 1, 1, 2, 1, 1], np.int64)
    _, ci = indexers.volume_bar_indexer_q(_t(ts), _t(units), 2.5e-8, 1e-8)
    assert ci.tolist() == [0, 2, 4]
