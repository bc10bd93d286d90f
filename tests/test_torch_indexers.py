"""Time-bar indexer and trade quantization of finmlkit_tpu_torch against the
JAX package, on the scenarios of tests/bars/test_time_indexer_scenarios.py.
Clock values and close indices must be exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from finmlkit_tpu.bar.indexers import time_bar_indexer as jax_time_bar_indexer
from finmlkit_tpu.bar.quantize import quantize_trades as jax_quantize_trades
from finmlkit_tpu_torch.bar.indexers import time_bar_indexer
from finmlkit_tpu_torch.bar.quantize import quantize_trades
from finmlkit_tpu_torch.testing import assert_exact

SEC = 1_000_000_000


def _exp_ts(seed, n, mean_s):
    r = np.random.default_rng(seed)
    return 1_700_000_000 * SEC + np.cumsum(
        (r.exponential(mean_s, n) * 1e9).astype(np.int64))


def _gappy_ts(seed, n=3000, gap_frac=0.2):
    r = np.random.default_rng(seed)
    dt = (r.exponential(5.0, n) * 1e9).astype(np.int64)
    dt[r.random(n) < gap_frac / 50] += int(600e9)  # empty bars
    return 1_700_000_000 * SEC + np.cumsum(dt)


T0 = 1_700_000_000 * SEC
ALIGNED = (1_700_000_000 // 60) * 60 * SEC
SCENARIOS = {
    "on_boundary": (np.array([1 * SEC, 60 * SEC, 61 * SEC]), 60.0),
    "one_ns_after": (np.array([1 * SEC, 60 * SEC + 1]), 60.0),
    "one_ns_before": (np.array([1 * SEC, 60 * SEC - 1]), 60.0),
    **{f"sweep_{iv:g}s": (_exp_ts(int(iv), 2000, 2.0), iv)
       for iv in (1.0, 5.0, 30.0, 60.0, 300.0, 3600.0)},
    **{f"subsecond_{iv:g}s": (_exp_ts(3, 1000, 0.2), iv)
       for iv in (0.5, 0.25, 1.5)},
    "large_interval": (np.array([10 * SEC, 500 * SEC, 900 * SEC]), 86400.0),
    "single_trade": (np.array([T0 + 37 * SEC]), 60.0),
    "identical_timestamps": (np.full(10, T0 + 30 * SEC), 60.0),
    "aligned_start": (np.array([ALIGNED, ALIGNED + 10 * SEC,
                                ALIGNED + 70 * SEC]), 60.0),
    "microsecond": (T0 + np.arange(5000) * 1000, 0.001),
    "empty_bars": (_gappy_ts(3, gap_frac=1.0), 60.0),
    "empty_bars_dense": (_gappy_ts(7, gap_frac=2.0), 60.0),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_time_bar_indexer_matches_jax(name):
    ts, interval = SCENARIOS[name]
    ts = np.asarray(ts, np.int64)
    clock_j, ci_j = jax_time_bar_indexer(jnp.asarray(ts), interval,
                                         ts_first=int(ts[0]),
                                         ts_last_i=int(ts[-1]))
    clock, ci = time_bar_indexer(torch.from_numpy(ts), interval)
    assert_exact(clock, np.asarray(clock_j), "clock")
    assert_exact(ci, np.asarray(ci_j), "ci")


def test_quantize_matches_jax():
    r = np.random.default_rng(0)
    n = 20000
    price = np.round(107_000.0 * np.exp(np.cumsum(r.normal(0, 2e-5, n))), 1)
    amount = np.maximum(np.round(r.lognormal(-4.0, 1.5, n), 5),
                        1e-5).astype(np.float32)
    amount[::11] = np.float32(40.0)  # above 2^31 units
    q, q_j = quantize_trades(price, amount), jax_quantize_trades(price, amount)
    assert (q.tick_size, q.amount_scale, q.exact) == \
        (q_j.tick_size, q_j.amount_scale, q_j.exact)
    assert_exact(q.price_ticks, q_j.price_ticks, "ticks")
    assert_exact(q.amount_units, q_j.amount_units, "units")
    assert q.amount_units.max() > 2**31
    assert quantize_trades(np.array([1.0, 1.0 + 1e-13]), amount[:2]) is None
