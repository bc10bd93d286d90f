"""The exact float64 volume and dollar walks of finmlkit_tpu_torch
(``ops/float_walk.py``, the plain versions of kernel D) and the float64 volume
and dollar indexers (``bar/indexers.py``) against the JAX package's exact tier
on the CPU: the native loops ``finmlkit_tpu.native.volume_bar_boundaries`` and
``dollar_bar_boundaries`` (``native/seg_stats.cpp:183-211``) and the kits'
host indexers ``volume_bar_indexer_host`` and ``dollar_bar_indexer_host``,
and against an unfused Python oracle of that source written here.

Every close is exact. The streams cover thresholds that one trade's value
exceeds, a threshold reached exactly, the ``max_bars`` cap and n = 1. One
constructed stream pins ROADMAP R15: a host build with FMA (``-march=native``)
and the unfused source close its bars differently there; the port follows the
source.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from finmlkit_tpu import native
from finmlkit_tpu.bar import indexers as jidx
from finmlkit_tpu_torch.bar import indexers
from finmlkit_tpu_torch.ops import float_walk
from finmlkit_tpu_torch.testing import assert_exact
from tests.test_torch_kit import native_library  # noqa: F401  (the native build)

N = 20_000


def unfused_oracle(values, thr, max_bars, reset):
    """``seg_stats.cpp:183-211`` as written, over float64 ``values`` (the
    volumes, or the rounded products): each add and subtract rounds once."""
    out, k = [], 0
    if len(values) == 0:
        return np.asarray(out, np.int64)
    cum = float(values[0])
    i = 1
    while i < len(values) and k < max_bars:
        cum = cum + float(values[i])
        if cum >= thr:
            out.append(i)
            k += 1
            cum = 0.0 if reset else cum - thr
        i += 1
    return np.asarray(out, np.int64)


def fma(a: float, b: float, c: float) -> float:
    """``a * b + c`` rounded once (an exact fused multiply-add)."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def fused_dollar_oracle(prices, volumes, thr, max_bars):
    """The dollar loop as a host compiler with FMA builds it: the first
    product unfused, each later step ``cum = fma(p, v, cum)``."""
    out = []
    cum = float(prices[0]) * float(volumes[0])
    for i in range(1, len(prices)):
        if len(out) >= max_bars:
            break
        cum = fma(float(prices[i]), float(volumes[i]), cum)
        if cum >= thr:
            out.append(i)
            cum = cum - thr
    return np.asarray(out, np.int64)


def _stream(name):
    """(prices float64 on no tick grid, volumes float32) of a named stream."""
    g = np.random.default_rng(11)
    if name == "n1":
        return np.array([101.37]), np.array([0.25], np.float32)
    if name == "exact":    # running sums of dyadic values reach 1.0 exactly
        v = np.tile(np.array([0.5, 0.25, 0.25, 0.125, 0.375, 0.5], np.float32), 50)
        return np.full(len(v), 2.0), v
    px = 107_000.0 * np.exp(np.cumsum(g.normal(0, 2e-5, N)))
    v = np.maximum(g.lognormal(-4.0, 1.5, N), 1e-5).astype(np.float32)
    if name == "whales":   # trades far above the threshold among small ones
        v[::97] *= 400
    return px, v


# (stream, threshold as a share of the total value (below 1) or itself, cap)
CASES = [("lognormal", 1 / 500, None), ("lognormal", 1 / 20, None),
         ("lognormal", 1 / 5000, None), ("whales", 1 / 2000, None),
         ("whales", 1 / 2000, 7), ("lognormal", 1 / 500, 0), ("exact", 1.0, None),
         ("n1", 1 / 2, None)]


def _ids(case):
    return f"{case[0]}-{case[1]:g}-{case[2]}"


@pytest.fixture(params=CASES, ids=_ids)
def case(request, native_library):  # noqa: F811
    name, share, cap = request.param
    px, v = _stream(name)
    return name, share, cap, px, v


def _thr(share, total):
    """A share of the total below 1, else the threshold itself."""
    return share if share >= 1 else share * total


@pytest.mark.parametrize("mode", ["volume", "dollar"])
def test_walks_match_native_and_oracle(case, mode):
    name, share, cap, px, v = case
    values = v.astype(np.float64) if mode == "volume" else px * v.astype(np.float64)
    thr = _thr(share, float(values.sum()))
    mb = int(values.sum() / thr) + 2 if cap is None else cap
    if mode == "volume":
        want = native.volume_bar_boundaries(v, thr, mb)
        plain = float_walk.volume_walk_plain(torch.from_numpy(v), thr, mb)
        got = float_walk.volume_walk(torch.from_numpy(v), thr, mb)
    else:
        want = native.dollar_bar_boundaries(px, v, thr, mb)
        plain = float_walk.dollar_walk_plain(torch.from_numpy(px), torch.from_numpy(v),
                                             thr, mb)
        got = float_walk.dollar_walk(torch.from_numpy(px), torch.from_numpy(v), thr, mb)
    oracle = unfused_oracle(values, thr, mb, reset=mode == "volume")
    assert_exact(plain, oracle, f"{mode} plain vs the unfused oracle")
    assert_exact(got, plain, f"{mode} walk on the CPU vs plain")
    assert_exact(plain, want, f"{mode} plain vs native")
    if cap is not None:
        assert len(plain) == cap
    if name == "n1":
        assert len(plain) == 0
    if name == "exact" and mode == "volume":
        assert plain[:2].tolist() == [2, 5]   # 0.5 + 0.25 + 0.25 == 1.0 closes


def test_single_trade_above_threshold_closes_each_trade():
    # every trade from 1 on exceeds the threshold by itself: a close each
    v = np.full(50, 3.0, np.float32)
    for walk in (lambda: float_walk.volume_walk_plain(torch.from_numpy(v), 1.0, 100),
                 lambda: float_walk.dollar_walk_plain(torch.full((50,), 1.0, dtype=torch.float64),
                                                      torch.from_numpy(v), 1.0, 100)):
        got = walk().tolist()
        assert got[:5] == [1, 2, 3, 4, 5]
    # dollar carries the remainder: 3 + 3 - 1 = 5 >= 1, so still a close each,
    # and the carry grows by 2 a trade
    assert len(float_walk.dollar_walk_plain(torch.ones(50, dtype=torch.float64),
                                            torch.from_numpy(v), 1.0, 100)) == 49


@pytest.mark.parametrize("name,share", [("lognormal", 1 / 500), ("whales", 1 / 3000),
                                        ("exact", 1.0), ("n1", 1 / 2)])
def test_indexers_match_jax_host_tier(name, share, native_library):  # noqa: F811
    px, v = _stream(name)
    ts = 1_700_000_000_000_000_000 + np.cumsum(np.full(len(v), 70_000_000, np.int64))
    t_ts = torch.from_numpy(ts)
    vol_thr = _thr(share, float(v.astype(np.float64).sum()))
    want = jidx.volume_bar_indexer_host(ts, v, vol_thr)
    got = indexers.volume_bar_indexer(t_ts, torch.from_numpy(v), vol_thr)
    assert_exact(got[1], want[1], "volume ci")
    assert_exact(got[0], want[0], "volume close_ts")
    dol_thr = _thr(share, float((px * v).sum()))
    want = jidx.dollar_bar_indexer_host(ts, px, v, dol_thr)
    got = indexers.dollar_bar_indexer(t_ts, torch.from_numpy(px), torch.from_numpy(v),
                                      dol_thr)
    assert_exact(got[1], want[1], "dollar ci")
    assert_exact(got[0], want[0], "dollar close_ts")
    plain = indexers.dollar_bar_indexer(t_ts, torch.from_numpy(px), torch.from_numpy(v),
                                        dol_thr, walk=float_walk.dollar_walk_plain)
    assert_exact(plain[1], got[1], "dollar ci, plain walk")


def _r15_stream():
    """Two trades after which the fused step reaches the threshold and the
    unfused step falls an ulp short: the threshold is set to the fused sum of
    the first two trades' dollars, at a pair where the two differ."""
    g = np.random.default_rng(15)
    while True:
        p = 100.0 + g.random(2) * 10.0
        v = g.lognormal(-2.0, 1.0, 2).astype(np.float32)
        cum = float(p[0]) * float(v[0])
        fused = fma(float(p[1]), float(v[1]), cum)
        unfused = cum + float(p[1]) * float(v[1])
        if unfused < fused:
            return p, v, fused


def test_r15_port_follows_the_unfused_source():
    # ROADMAP R15: finmlkit_tpu/native builds seg_stats.cpp with -march=native,
    # which contracts the dollar step `cum += prices[i] * (double)volumes[i]`
    # into one FMA where the host has it; the source rounds the product and
    # the sum apart. On this stream the two disagree about trade 1's close,
    # and the port (kernel D and its plain version) follows the source.
    p, v, thr = _r15_stream()
    p = np.concatenate([p, [100.0]])
    v = np.concatenate([v, np.array([0.0], np.float32)])
    unfused = unfused_oracle(p * v.astype(np.float64), thr, 10, reset=False)
    fused = fused_dollar_oracle(p, v, thr, 10)
    assert fused.tolist() == [1] and unfused.tolist() == []
    got = float_walk.dollar_walk_plain(torch.from_numpy(p), torch.from_numpy(v), thr, 10)
    assert_exact(got, unfused, "R15: the port's dollar walk vs the unfused source")


def test_walks_check_their_inputs():
    v = torch.ones(10, dtype=torch.float32)
    with pytest.raises(TypeError):
        float_walk.volume_walk(v.to(torch.float64), 1.0, 5)
    with pytest.raises(TypeError):
        float_walk.dollar_walk(torch.ones(10, dtype=torch.float32), v, 1.0, 5)
    with pytest.raises(TypeError):
        float_walk.dollar_walk(torch.ones(9, dtype=torch.float64), v, 1.0, 5)
    # a threshold of at most 0 closes at every trade from 1 on (the JAX
    # helpers divide by it); the buffer holds n closes
    ts = torch.arange(10, dtype=torch.int64)
    assert indexers.volume_bar_indexer(ts, v, 0.0)[1].tolist() == list(range(10))


def _block_stream(name, n=30_000):
    """Float64 values for kernel D's block walk: positive, with negative
    values, with a NaN, with an infinity, and dyadic values whose running
    sums hit the threshold exactly, at block and chunk edges among others."""
    g = np.random.default_rng(17)
    x = np.maximum(g.lognormal(-4.0, 1.5, n), 1e-5)
    if name == "negatives":
        x[::7] *= -1.0
    elif name == "nan":
        x[12_345] = np.nan
    elif name == "inf":
        x[20_000] = np.inf
    elif name == "dyadic":
        x = g.integers(0, 8, n) / 8.0          # sums of eighths are exact
    return x


@pytest.mark.parametrize("name", ["positive", "negatives", "nan", "inf", "dyadic"])
@pytest.mark.parametrize("chunk,block", [(2048, 16), (37, 4), (64, 16), (5, 16)])
@pytest.mark.parametrize("reset", [True, False], ids=["volume", "dollar"])
def test_block_walk_model_matches_plain(name, chunk, block, reset):
    # kernel D adds a block of values at once where all are >= 0 and the sum
    # stays below the threshold; every close, cap and special value must come
    # out as the step-by-step loop's
    x = _block_stream(name)
    finite = x[np.isfinite(x)]
    thr = 2.0 if name == "dyadic" else float(np.abs(finite).sum()) / 700
    for cap in (10**6, 13):
        want = unfused_oracle(x, thr, cap, reset)
        got, again = float_walk.walk_blocks(x, thr, cap, reset, chunk=chunk, block=block)
        assert_exact(got, want, f"{name} chunk {chunk} block {block} cap {cap}")
        if cap == 13:
            assert len(got) == 13
    assert again > 0 or block > chunk        # a chunk below a block: all steps
