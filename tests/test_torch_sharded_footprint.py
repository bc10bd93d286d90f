"""The port's sharded footprints and rolling volume profile
(``parallel/sharded_footprint.py``) over gloo on the CPU, against the port's
single-device functions and the JAX package's sharded ones.

One group of 4 ranks, spawned once for the file, computes every case
(``parallel/dryrun.py suite``, "footprints"): the dollar bars' footprints and
their rolling profile (600 s, 5 bins) on the first rank, the first 3 (uneven
spans) and all 4, on the synthetic trades and on their dyadic form, and R19's
grid. Against the single-device functions: bit for bit, but the profile's
``pct`` within rtol 1e-12. Against the JAX sharded functions on conftest's 8
virtual devices, on the dyadic trades: levels, ticks and flags exact, the
float32 volumes within an ulp, ``pct`` (float32 there, ROADMAP R5) within
1e-6. R19: the JAX function casts ``round(price / tick)`` to int32 unchecked
and returns levels that wrapped; the port raises.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from finmlkit_tpu.parallel import sharded as jsh  # noqa: E402
from finmlkit_tpu.parallel import sharded_footprint as jsf  # noqa: E402
from finmlkit_tpu.parallel.mesh import time_mesh as jax_time_mesh  # noqa: E402
from finmlkit_tpu_torch.parallel import dryrun  # noqa: E402
from finmlkit_tpu_torch.parallel.mesh import spawn_mesh  # noqa: E402

N = 6_007
SEED = 17
KEYS = ("ci", "footprints.low_level", "footprints.n_levels", "footprints.buy_volumes",
        "footprints.sell_volumes", "footprints.buy_ticks", "footprints.sell_ticks",
        "footprints.buy_imbalances", "footprints.sell_imbalances",
        "footprints.buy_imbalances_sum", "footprints.sell_imbalances_sum",
        "footprints.cot_price_levels", "footprints.imb_max_run_signed",
        "footprints.vp_skew", "footprints.vp_gini", "profile.0", "profile.1", "profile.2",
        "profile.3")


@pytest.fixture(scope="module")
def ranks():
    return spawn_mesh(dryrun.suite, 4, args=("footprints", N, SEED), device="cpu",
                      timeout=120)


@pytest.fixture(scope="module")
def single():
    return dryrun.single_footprints(dryrun.synth_trades(N, SEED), "cpu")


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("world", [1, 3, 4])
def test_matches_single_device(ranks, single, world, key):
    want = single[key]
    for r in range(world):
        got = ranks[r]["synth"][world][key]
        assert got.dtype == want.dtype and got.shape == want.shape
        if key == "profile.3":
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r} of {world}")
    assert want.size > 20


@pytest.mark.parametrize("world", [1, 3, 4])
def test_dyadic_matches_jax_sharded(ranks, world):
    cols = dryrun.synth_trades(N, SEED, dyadic=True)
    ts, price, amount, side = cols
    got = ranks[0]["dyadic"][world]
    ci = got["ci"]
    mesh = jax_time_mesh(8)
    trades = jsh.shard_trades({"price": price, "amount": amount, "side": side}, mesh)
    prod = jsh.sharded_bar_products(trades, ci, mesh)
    fp = jsf.sharded_bar_footprints(trades, ci, np.asarray(prod["low"]),
                                    np.asarray(prod["high"]), dryrun.DYADIC_TICK, 3.0,
                                    mesh, n=N)
    for k in ("low_level", "n_levels", "buy_ticks", "sell_ticks", "buy_imbalances",
              "sell_imbalances", "cot_price_levels", "imb_max_run_signed"):
        np.testing.assert_array_equal(got[f"footprints.{k}"], np.asarray(fp[k]), err_msg=k)
    for k in ("buy_volumes", "sell_volumes"):
        np.testing.assert_allclose(got[f"footprints.{k}"], np.asarray(fp[k]),
                                   rtol=2.0 ** -23, err_msg=k)
    prof = jsf.sharded_volume_profile_rolling(
        ts[ci[1:]], got["footprints.low_level"], got["footprints.n_levels"],
        got["footprints.buy_volumes"], got["footprints.sell_volumes"], 600.0, mesh,
        n_bins=5)
    for i in range(3):
        np.testing.assert_array_equal(got[f"profile.{i}"], np.asarray(prof[i]))
    np.testing.assert_allclose(got["profile.3"], np.asarray(prof[3]), rtol=1e-6, atol=1e-7)


def test_r19_levels_outside_int32_raise(ranks):
    """A tick of 1e-9 puts prices near 100 at levels near 1e11: the port raises
    on every rank; the JAX function wraps them into int32 and goes on."""
    for r in range(4):
        assert "leave int32" in ranks[r]["pins"]["r19"]
    p = dryrun.pin_streams()
    px = np.where(p["px"] > 0, p["px"], 100.0)
    mesh = jax_time_mesh(8)
    trades = jsh.shard_trades({"price": px, "amount": p["vol"], "side": p["side"]}, mesh)
    ci = np.array([-1, len(px) // 2, len(px) - 1])
    fp = jsf.sharded_bar_footprints(trades, ci, np.array([50.0, 60.0]),
                                    np.array([150.0, 160.0]), 1e-9, 3.0, mesh,
                                    max_levels=4, n=len(px))
    low = np.asarray(fp["low_level"])
    assert low.dtype == np.int32
    assert not np.array_equal(low.astype(np.int64), np.round(np.array([50.0, 60.0]) / 1e-9))
    assert jnp.asarray(fp["buy_volumes"]).shape == (2, 4)
