"""The host median engine ``medians="host"`` (``finmlkit_tpu_torch/native``,
the port's copy of ``seg_median_pair``) on the CPU.

Its pair equals ``finmlkit_tpu.native.seg_median_pair``'s and the sort
engine's bit for bit on every non-empty bar (empty bars give 0, which the
finals mask), on ``testing.adversarial_trades`` (empty, one-trade and long
bars, ties, an open anchor inside the trades) at 1 thread and at all of them;
a kit with ``medians="host"`` equals ``"sort"`` bit for bit. The library is
built by ``g++`` without ``-march=native``, and a missing ``g++`` raises.
"""
import time

import numpy as np
import pytest
import torch

from finmlkit_tpu import native as jnative
from finmlkit_tpu_torch import native
from finmlkit_tpu_torch.bar import fused, kit
from finmlkit_tpu_torch.testing import adversarial_trades, assert_exact
from tests.conftest import generate_trades


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library; another test process may still be
    writing it into the package directory, so look again until it loads."""
    for _ in range(120):
        if jnative.lib() is not None:
            return jnative
        jnative._TRIED = False
        time.sleep(0.5)
    pytest.fail("finmlkit_tpu's native library does not build or load")


CASES = [dict(n=5000, seed=0), dict(n=5000, seed=1, first=40),
         dict(n=20000, seed=2, long_bar=12345), dict(n=3000, seed=3, mean_bar=2),
         dict(n=3000, seed=4, mean_bar=1)]


@pytest.mark.parametrize("threads", ["one", "all"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_pair_matches_jax_native_and_sort(jax_native, case, threads):
    *_, amounts, ci = adversarial_trades(**case)
    counts = np.diff(ci)
    if case.get("mean_bar", 600) <= 2:
        assert (counts == 0).any() and (counts == 1).any()
    a, b = native.seg_median_pair(amounts, ci, threads=1 if threads == "one" else native.THREADS)
    ja, jb = jax_native.seg_median_pair(amounts, ci)
    assert_exact(a, ja, "med_a")
    assert_exact(b, jb, "med_b")
    assert not a[counts == 0].any() and not b[counts == 0].any()
    sa, sb = fused.median_engine("sort")(torch.from_numpy(amounts), torch.from_numpy(ci))
    full = counts > 0
    assert_exact(a[full], sa.numpy()[full], "med_a vs sort")
    assert_exact(b[full], sb.numpy()[full], "med_b vs sort")
    ha, hb = fused.median_engine("host")(torch.from_numpy(amounts), torch.from_numpy(ci))
    assert_exact(ha, a, "engine med_a")
    assert_exact(hb, b, "engine med_b")


def test_no_bars_and_bad_ci():
    vals = np.arange(10, dtype=np.float32)
    a, b = native.seg_median_pair(vals, np.array([-1]))
    assert a.shape == b.shape == (0,)
    for ci in ([-2, 5], [-1, 10], [3, 1], []):
        with pytest.raises(ValueError, match="ci"):
            native.seg_median_pair(vals, np.array(ci, np.int64))


@pytest.mark.parametrize("name, extra", [("time", (30.0,)), ("tick", (37,))])
def test_kit_host_equals_sort(name, extra):
    ts, px, amt, side = generate_trades(n=6000, seed=5)
    cls = {"time": kit.TimeBarKit, "tick": kit.TickBarKit}[name]
    before = native.CALLS
    host = cls(ts, px, amt, side, *extra, device="cpu", medians="host")
    got = host.build_ohlcv()
    assert native.CALLS == before + 1
    want = cls(ts, px, amt, side, *extra, device="cpu").build_ohlcv()
    for c in want:
        assert_exact(got[c], want[c], c)
    plain = cls(ts, px, amt, side, *extra, device="cpu", medians="host", plain=True)
    assert_exact(plain.build_ohlcv()["median_trade_size"], want["median_trade_size"])


def test_build_flags_and_name():
    assert "-march=native" not in native.FLAGS
    assert {"-O3", "-std=c++17", "-pthread", "-fPIC"} <= set(native.FLAGS)
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libfmk_host_")
    native.library()
    assert path.exists()


def test_missing_gxx_raises(monkeypatch, tmp_path):
    """No fallback to another engine: without ``g++`` the build raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.seg_median_pair(np.ones(4, np.float32), np.array([-1, 3]))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        kit.TimeBarKit(*generate_trades(n=500, seed=6), 30.0, device="cpu",
                       medians="host").build_ohlcv()
