"""Kernel H's pass over fixed tiles, modelled on the CPU (``ops/segment_hist.py
hist_pass_tiles`` and ``less_pass_tiles``): tiles of ``items * threads``
trades, a thread's consecutive trades counted bar by bar, a bar inside one
thread stored whole, heads and tails joined across lanes, warps and tiles.
Held to ``hist_pass_plain`` and ``less_pass_plain`` bit for bit at every shift,
on bars longer than a tile, empty bars, runs of one-trade bars, ``ci[0] = -1``
and ``ci[0] >= 0`` with trades after the last bar, at several tile shapes (the
kernel's is 16 trades a thread, 256 threads), and on bases 2^30 away from the
amounts at the last shift, as the hist engine makes them.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.ops import segment_hist as sh
from finmlkit_tpu_torch.testing import assert_exact, zeros_and_twos

N = 3000


def _case(name, seed=5):
    """(bits, ci) of ``name`` over N trades of lognormal float32 amounts."""
    rng = np.random.default_rng(seed)
    amt = rng.lognormal(-4.0, 1.5, N).astype(np.float32)
    amt[::13] = amt[7]                                   # ties
    if name == "long_bars":                              # bars over many tiles
        ci = [-1, 1500, 2990]
    elif name == "empty_bars":
        c = np.sort(rng.integers(0, N, 60))
        ci = np.concatenate([[-1], c, c[10:15], [c[-1]] * 4])
    elif name == "one_trade_bars":
        ci = np.concatenate([[-1], np.arange(0, 700), np.arange(703, 1400, 5),
                             [N - 1]])
    elif name == "anchor_inside":                        # ci[0] >= 0, a tail
        ci = np.concatenate([[211], np.sort(rng.integers(212, N - 40, 30))])
    else:                                                # "mixed"
        ci = np.concatenate([[-1], np.sort(rng.integers(0, N, 45)), [N - 1]])
    ci = np.sort(np.asarray(ci, np.int64))
    return torch.from_numpy(amt.view(np.int32)), torch.from_numpy(ci)


NAMES = ("mixed", "long_bars", "empty_bars", "one_trade_bars", "anchor_inside")
SHAPES = [(1, 32), (3, 64), (16, 256), (5, 96)]   # (trades a thread, threads)


@pytest.mark.parametrize("items,threads", SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_tiles_match_plain(name, items, threads):
    bits, ci = _case(name)
    nb = len(ci) - 1
    rng = np.random.default_rng(len(name))
    # bases near each bar's first amount, so that every pass finds counts
    first = bits[(ci[:-1] + 1).clamp(0, N - 1)]
    base = first - torch.from_numpy(rng.integers(0, 1 << 22, nb).astype(np.int32))
    for s in sh.SHIFTS:
        assert_exact(sh.hist_pass_tiles(bits, ci, base, s, items=items, threads=threads),
                     sh.hist_pass_plain(bits, ci, base, s), f"{name} s={s}")
    for got, want in zip(sh.less_pass_tiles(bits, ci, first, items=items, threads=threads),
                         sh.less_pass_plain(bits, ci, first)):
        assert_exact(got, want, f"{name} less")


@pytest.mark.parametrize("name", NAMES)
def test_tiles_medians_match_plain_engine(name):
    """The hist engine through the tiled passes gives the plain engine's
    brackets."""
    bits, ci = _case(name)
    amounts = bits.view(torch.float32)
    got = sh.segment_median_pair_hist(
        amounts, ci, hist=lambda *a: sh.hist_pass_tiles(*a, items=3, threads=64),
        less=lambda *a: sh.less_pass_tiles(*a, items=3, threads=64))
    for a, b in zip(got, sh.segment_median_pair_hist(amounts, ci)):
        assert_exact(a, b, name)


def _i32(t):
    """int64 to int32, wrapping."""
    return ((t + 2**31) % 2**32 - 2**31).to(torch.int32)


@pytest.mark.parametrize("c", [1, 2, 3])
@pytest.mark.parametrize("name", NAMES)
def test_tiles_far_bases_match_plain(name, c):
    """At s = 0, bases c * 2^30 from a bar's first amount, less 7: there f is
    c * 2^30 + 7 (int32), in no bucket, and no wrap of the kernel's shift may
    count it in bucket 7. Every other bar keeps a base near its amounts."""
    bits, ci = _case(name)
    first = bits[(ci[:-1] + 1).clamp(0, N - 1)].long()
    far = torch.arange(len(ci) - 1) % 2 == 0
    base = _i32(torch.where(far, first - (c << 30) - 7, first - 3))
    for items, threads in SHAPES:
        assert_exact(sh.hist_pass_tiles(bits, ci, base, 0, items=items, threads=threads),
                     sh.hist_pass_plain(bits, ci, base, 0), f"{name} c={c}")


@pytest.mark.parametrize("items,threads", SHAPES)
def test_tiles_medians_of_zeros_and_twos(items, threads):
    """The hist engine through the tiled passes on bars of 0.0 and 2.0: the
    plain engine's brackets, and the middle values of each sorted bar."""
    amounts, ci = zeros_and_twos(40)
    got = sh.segment_median_pair_hist(
        amounts, ci, hist=lambda *a: sh.hist_pass_tiles(*a, items=items, threads=threads),
        less=lambda *a: sh.less_pass_tiles(*a, items=items, threads=threads))
    for a, b in zip(got, sh.segment_median_pair_hist(amounts, ci)):
        assert_exact(a, b, "vs plain engine")
    bars = [np.sort(amounts.numpy()[ci[k] + 1:ci[k + 1] + 1]) for k in range(len(ci) - 1)]
    assert_exact(got[0], torch.tensor([b[(len(b) - 1) // 2] for b in bars]), "lower middle")
    assert_exact(got[1], torch.tensor([b[len(b) // 2] for b in bars]), "upper middle")
