"""The dollar-bar indexer of finmlkit_tpu_torch (``dollar_bar_indexer_q``,
plain path of kernel S) against the JAX package on the CPU.

Close indices and close timestamps must be bit-exact against the JAX
``dollar_bar_indexer_q`` (the same integer rule). Against the float64
``dollar_bar_indexer`` the bar count must agree and at least 99.9% of the
closes lie within one trade (the JAX package's own bound,
``tests/bars/test_aggregate_q.py``): the float path rounds near a threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import dollar_ci_numpy, synth_trades
from finmlkit_tpu.bar import indexers as jidx
from finmlkit_tpu.bar.quantize import quantize_trades as jax_quantize_trades
from finmlkit_tpu_torch import interop
from finmlkit_tpu_torch.bar.indexers import dollar_bar_indexer_q
from finmlkit_tpu_torch.bar.quantize import quantize_trades
from finmlkit_tpu_torch.testing import assert_exact
from finmlkit_tpu_torch.utils import trace
from tests.conftest import generate_trades

N = 50_000


def _trades(kind):
    if kind == "synth":   # bench.py's month generator: BTC-like prices, 0.1 tick
        return synth_trades(N, seed=3)
    ts, px, amt, side = generate_trades(n=5000, seed=1)  # the JAX tests' trades
    return ts, px, amt.astype(np.float32), side


# (trades, threshold as a fraction of the total dollars, or dollars)
CASES = [("synth", 1 / 50), ("synth", 1 / 2000), ("synth", 0.7),
         ("small", 500.0)]


def _threshold(price, amount, thr):
    total = float((price * amount.astype(np.float64)).sum())
    return thr * total if thr < 1 else thr


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]:g}")
def case(request):
    kind, thr = request.param
    ts, price, amount, side = _trades(kind)
    thr = _threshold(price, amount, thr)
    q = jax_quantize_trades(price, amount)
    want = jidx.dollar_bar_indexer_q(
        jnp.asarray(ts), jnp.asarray(q.price_ticks),
        jnp.asarray(q.amount_units), thr, q.tick_size, q.amount_scale)
    q_port = quantize_trades(price, amount)
    t = interop.from_numpy(q_port, None, side, amount, "cpu", timestamps=ts)
    return dict(ts=ts, price=price, amount=amount, thr=thr, q=q_port, t=t,
                want=[np.asarray(x) for x in want])


def test_ci_and_close_ts_bit_exact(case):
    t = case["t"]
    before = trace.counter("launch.S")
    close_ts, ci = dollar_bar_indexer_q(t.timestamps, t.ticks, t.units,
                                        case["thr"], t.tick_size, t.amount_scale)
    assert trace.counter("launch.S") == before  # CPU tensors: the plain scan
    want_ts, want_ci = case["want"]
    assert_exact(ci, want_ci, "ci")
    assert_exact(close_ts, want_ts, "close timestamps")
    assert int(ci[0]) == 0 and len(ci) >= 2
    assert bool((ci[1:] > ci[:-1]).all())


def test_close_to_f64_indexer(case):
    want_ci = case["want"][1]
    _, ci64 = jidx.dollar_bar_indexer(
        jnp.asarray(case["ts"]), jnp.asarray(case["price"]),
        jnp.asarray(case["amount"]), case["thr"])
    a, b = want_ci, np.asarray(ci64)
    assert len(a) == len(b)
    assert np.mean(np.abs(a - b) <= 1) > 0.999


def test_numpy_rule_matches(case):
    # chip_smoke.py holds the card's close indices to this numpy recomputation
    assert_exact(dollar_ci_numpy(case["q"], case["thr"]), case["want"][1],
                 "numpy rule")


@pytest.mark.parametrize("dollars,want", [
    # prefix 10, 20, 45, 50, 80; with threshold 20 the closes are the first
    # trades reaching 20, 40, 60 -> 1, 2, 4; 80 is also first reached at
    # trade 4, so the fourth close moves one trade on, past the end
    ([10, 10, 25, 5, 30], [0, 1, 2, 4]),
    # trade 0 alone reaches 20, but the check starts at trade 1
    ([30, 5, 30], [0, 1, 2]),
])
def test_hand_computed(dollars, want):
    # tick 1 and 64 units per dollar: one dollar unit per dollar after >> 6
    n = len(dollars)
    ticks = torch.ones(n, dtype=torch.int32)
    units = torch.tensor(dollars, dtype=torch.int64) * 64
    ts = torch.arange(n, dtype=torch.int64) * 1000
    close_ts, ci = dollar_bar_indexer_q(ts, ticks, units, 20.0, 1.0, 1 / 64)
    assert ci.tolist() == want
    assert close_ts.tolist() == [1000 * i for i in want]
