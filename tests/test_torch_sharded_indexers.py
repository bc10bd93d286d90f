"""The port's sharded indexers (``parallel/sharded_indexers.py``) over gloo on
the CPU, against the port's single-device indexers and the JAX package's
sharded ones.

One group of 4 ranks, spawned once for the file, computes every case
(``parallel/dryrun.py suite``): all the indexers on the first rank alone, on
the first 3 ranks with uneven spans (1 : 2 : 3, each rank passing its own span
and offset) and on all 4, on the synthetic trades and on their dyadic form,
and the streams of the JAX faults the port does not copy. Each case is then
checked by a test of its own:

- the closes of every rank, at every world size, equal the single-device
  indexers' bit for bit;
- on the dyadic trades (exact float64 sums, as ``tests/parallel`` uses) they
  equal the JAX sharded indexers' on conftest's 8 virtual devices;
- R21: on one large trade and then ones, the JAX float volume ring searches
  prefix sums that round and moves closes; the port gives the loop's;
- R20: after a zero price, the JAX sharded CUSUM closes no bar (R10); the port
  follows the host loop.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from finmlkit_tpu.parallel import sharded_indexers as jsi  # noqa: E402
from finmlkit_tpu.parallel.mesh import time_mesh as jax_time_mesh  # noqa: E402
from finmlkit_tpu_torch.parallel import dryrun  # noqa: E402
from finmlkit_tpu_torch.parallel.mesh import spawn_mesh  # noqa: E402
from finmlkit_tpu_torch.testing import cusum_recurrence  # noqa: E402

N = 6_007
SEED = 11


@pytest.fixture(scope="module")
def ranks():
    return spawn_mesh(dryrun.suite, 4, args=("indexers", N, SEED), device="cpu", timeout=120)


@pytest.fixture(scope="module")
def single():
    return dryrun.single_indexers(dryrun.synth_trades(N, SEED), "cpu")


@pytest.mark.parametrize("case", dryrun.INDEXERS)
@pytest.mark.parametrize("world", [1, 3, 4])
def test_matches_single_device(ranks, single, world, case):
    want = single[case]
    assert len(want) > 5
    for r in range(world):
        np.testing.assert_array_equal(ranks[r]["synth"][world][case], want,
                                      err_msg=f"rank {r} of {world}")


def _jax_case(case, cols, mesh):
    ts, price, amount, side = cols
    p = dryrun._params(cols)
    a64 = amount.astype(np.float64)
    ema = dict(expected_ticks_init=16.0, alpha_ticks=0.1, alpha_rate=0.1, mesh=mesh)
    calls = {
        "time": lambda: jsi.sharded_time_bar_indexer(ts, p["interval"], mesh),
        "tick": lambda: jsi.sharded_tick_bar_indexer(ts, p["ticks_per_bar"], mesh),
        "volume": lambda: jsi.sharded_volume_bar_indexer(ts, a64, p["vol"], mesh),
        "volume_q": lambda: jsi.sharded_volume_bar_indexer(
            ts, None, p["vol"], mesh, amount_units=p["units"], amount_scale=1e-5),
        "dollar": lambda: jsi.sharded_dollar_bar_indexer(ts, price, a64, p["dol"], mesh),
        "dollar_q": lambda: jsi.sharded_dollar_bar_indexer(
            ts, None, None, p["dol"], mesh, price_ticks=p["ticks"], amount_units=p["units"],
            tick_size=dryrun.TICK, amount_scale=1e-5),
        "cusum": lambda: jsi.sharded_cusum_bar_indexer(ts, price, p["sigma"], 1e-9, 3.0,
                                                       mesh),
        "imbalance": lambda: jsi.sharded_imbalance_bar_indexer(
            ts, side, expected_rate_init=0.2, **ema),
        "imbalance_fixed": lambda: jsi.sharded_imbalance_bar_indexer(
            ts, side, threshold=20.0, mesh=mesh),
        "run": lambda: jsi.sharded_run_bar_indexer(ts, side, expected_rate_init=0.6, **ema),
        "run_volume": lambda: jsi.sharded_run_bar_indexer(
            ts, side, a64, threshold=float(np.median(amount)) * 20, mesh=mesh),
    }
    return np.asarray(calls[case]()[1])


@pytest.mark.parametrize("case", dryrun.INDEXERS)
def test_dyadic_matches_jax_sharded(ranks, case):
    cols = dryrun.synth_trades(N, SEED, dyadic=True)
    want = _jax_case(case, cols, jax_time_mesh(8))
    for world in (1, 3, 4):
        np.testing.assert_array_equal(ranks[0]["dyadic"][world][case], want,
                                      err_msg=f"{world} ranks")


def test_r21_float_volume_ring_is_the_loop(ranks):
    p = dryrun.pin_streams()
    x = p["vol"].astype(np.float64)
    cum, want = x[0], []
    for i in range(1, len(x)):
        cum += x[i]
        if cum >= 10.0:
            want.append(i)
            cum = 0.0
    want = np.concatenate([[0], want])
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["pins"]["r21"], want)
    got_jax = np.asarray(jsi.sharded_volume_bar_indexer(p["ts"], x, 10.0,
                                                        jax_time_mesh(8))[1])
    assert not np.array_equal(got_jax, want)    # the JAX ring moves closes (D1)


def test_r20_cusum_after_a_zero_price_follows_the_loop(ranks):
    p = dryrun.pin_streams()
    ts, px = p["ts"], p["px"]
    with np.errstate(divide="ignore", invalid="ignore"):
        rets = np.concatenate([[0.0], np.diff(np.log(px))])
    lam = np.maximum(3.0 * p["sigma"], 1e-9)
    can = np.concatenate([ts[:-1] != ts[1:], [True]])
    want = np.concatenate([[0], cusum_recurrence(rets, lam, can, 0)])
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["pins"]["r20"], want)
    assert (want > len(px) // 2).any()           # bars close after the zero price
    got_jax = np.asarray(jsi.sharded_cusum_bar_indexer(ts, px, p["sigma"], 1e-9, 3.0,
                                                       jax_time_mesh(8))[1])
    assert not (got_jax > len(px) // 2 + 1).any()    # R10: none after it
