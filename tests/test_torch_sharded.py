"""The port's sharded bar products and order statistics
(``parallel/sharded.py``) over gloo on the CPU, against the port's
single-device functions and the JAX package's sharded ones.

One group of 4 ranks, spawned once for the file, computes every case
(``parallel/dryrun.py suite``, "products"): the time bars' products,
trade-size features, medians and two order statistics a bar, an EWMA on the
closes and the triple barrier sharded over events with its weights, on the
first rank, the first 3 (uneven spans, each its own span and offset) and all
4, on the synthetic trades and on their dyadic form. Against the single-device
functions: integers, prices, medians, order statistics, labels and weights
bit for bit, the float64 sums within ``testing.hold_float_path``'s bounds.
Against the JAX sharded functions on conftest's 8 virtual devices, on the
dyadic trades: the tolerances of ``tests/parallel/test_sharded.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from finmlkit_tpu.parallel.mesh import time_mesh as jax_time_mesh  # noqa: E402
from finmlkit_tpu.parallel import sharded as jsh  # noqa: E402
from finmlkit_tpu_torch.bar.indexers import time_bar_indexer  # noqa: E402
from finmlkit_tpu_torch.parallel import dryrun  # noqa: E402
from finmlkit_tpu_torch.parallel.mesh import spawn_mesh  # noqa: E402
from finmlkit_tpu_torch.testing import FLOAT_PATH_EXACT, hold_float_path  # noqa: E402

N = 6_007
SEED = 13
COLS = dryrun.synth_trades(N, SEED)
EXACT = {"median", "kth", "ewma", "labels.0", "labels.1", "labels.2", "labels.3", "w_u",
         "w_r"} | {f"products.{k}" for k in FLOAT_PATH_EXACT}


@pytest.fixture(scope="module")
def ranks():
    return spawn_mesh(dryrun.suite, 4, args=("products", N, SEED), device="cpu", timeout=120)


@pytest.fixture(scope="module")
def single():
    return dryrun.single_products(COLS, "cpu")


KEYS = sorted(dryrun.single_products(dryrun.synth_trades(300, 1), "cpu"))


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("world", [1, 3, 4])
def test_matches_single_device(ranks, single, world, key):
    want = single[key]
    _, price, amount, _ = COLS
    for r in range(world):
        got = ranks[r]["synth"][world][key]
        assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
        if key in EXACT:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r} of {world}")
        else:
            group, name = key.split(".")
            want_all = {k.split(".")[1]: v for k, v in single.items()
                        if k.startswith(group + ".")}
            hold_float_path({name: got}, want_all, price, amount,
                            single["products.volume"], f"rank {r} of {world}")


def _jax_inputs():
    cols = dryrun.synth_trades(N, SEED, dyadic=True)
    ts, price, amount, side = cols
    _, ci = time_bar_indexer(torch.from_numpy(ts), dryrun._params(cols)["interval"])
    mesh = jax_time_mesh(8)
    trades = jsh.shard_trades({"price": price, "amount": amount, "side": side}, mesh)
    return cols, ci.numpy(), mesh, trades


JAX_PRODUCTS = ("open", "high", "low", "close", "volume", "vwap", "trades", "ticks_buy",
                "ticks_sell", "volume_buy", "volume_sell", "dollars_buy", "dollars_sell",
                "cum_ticks_min", "cum_ticks_max", "cum_volume_min", "cum_volume_max",
                "cum_dollars_min", "cum_dollars_max")


@pytest.mark.parametrize("world", [1, 3, 4])
def test_dyadic_products_match_jax_sharded(ranks, world):
    cols, ci, mesh, trades = _jax_inputs()
    want = jsh.sharded_bar_products(trades, ci, mesh)
    got = ranks[0]["dyadic"][world]
    for k in JAX_PRODUCTS:
        w, g = np.asarray(want[k]), got[f"products.{k}"]
        if k in ("trades", "ticks_buy", "ticks_sell", "cum_ticks_min", "cum_ticks_max"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in ("open", "high", "low", "close", "vwap"):
            np.testing.assert_allclose(g, w, rtol=1e-12, err_msg=k)
        elif k == "volume":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=2e-5, err_msg=k)


def test_dyadic_order_statistics_match_jax_sharded(ranks):
    cols, ci, mesh, trades = _jax_inputs()
    med = jsh.sharded_median_trade_size(trades, ci, mesh)
    kth = np.asarray(jsh.sharded_segment_kth(trades["amount"], ci, dryrun._kth_ranks(ci),
                                             mesh))
    counts = np.diff(ci)
    for world in (1, 3, 4):
        got = ranks[0]["dyadic"][world]
        np.testing.assert_array_equal(got["median"], med)
        np.testing.assert_array_equal(got["kth"][:, counts > 0], kth[:, counts > 0])


def test_dyadic_trade_size_features_match_jax_sharded(ranks):
    cols, ci, mesh, trades = _jax_inputs()
    theta = np.full(len(ci) - 1, float(np.median(cols[2])))
    want = jsh.sharded_trade_size_features(trades, ci, theta, mesh)
    for world in (1, 3, 4):
        got = ranks[0]["dyadic"][world]
        for k, w in want.items():
            np.testing.assert_allclose(got[f"trade_size.{k}"], np.asarray(w), rtol=1e-6,
                                       err_msg=k, equal_nan=True)
