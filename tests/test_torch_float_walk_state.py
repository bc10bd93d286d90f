"""Entry and exit sums of kernel D's walks on the CPU.

The walks from an entry sum (the volume since the last close, or the dollar
remainder, carried into trade 0, which is then checked): the plain loops
against the loop written out in numpy, kernel D's CPU models (the block walk
``walk_blocks``, the warp step ``walk_warp``, the chunked volume walk
``walk_chunked``, and the units route through kernel E's chunked model) from
the same sums against the plain loops, closes and exit sums bit for bit; a
stream walked in two parts, the second from the first's exit sum, against the
whole walk, on every route; and the route an entry sum takes (``route_of``).
"""
import math

import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.ops import event_scan as es
from finmlkit_tpu_torch.ops import float_walk as fw
from finmlkit_tpu_torch.testing import float_walk_case, same_state

N = 6_000
STREAMS = ("synth0", "ties", "exact", "whale")


def _values(name, mode):
    px, v, thr_v, thr_d, _ = float_walk_case(name, N)
    if mode == "volume":
        return v.astype(np.float64), thr_v
    return px * v.astype(np.float64), thr_d


def _loop(x, thr, reset, cum):
    """The loop of ``seg_stats.cpp:183-211`` from the sum ``cum`` before
    trade 0, trade 0 checked."""
    out = []
    for i, xi in enumerate(x.tolist()):
        cum += xi
        if cum >= thr:
            out.append(i)
            cum = 0.0 if reset else cum - thr
    return np.asarray(out, np.int64), cum


def _entries(thr):
    return {"zero": 0.0, "below": float(np.nextafter(thr, 0.0)), "half": thr / 2,
            "above": 2.5 * thr}


@pytest.mark.parametrize("entry", ["zero", "below", "half", "above"])
@pytest.mark.parametrize("mode", ["volume", "dollar"])
@pytest.mark.parametrize("name", STREAMS)
def test_plain_walk_from_entry_matches_the_loop(name, mode, entry):
    x, thr = _values(name, mode)
    cum0 = _entries(thr)[entry]
    want, want_end = _loop(x, thr, mode == "volume", cum0)
    got, end = fw._walk_plain(torch.from_numpy(x), thr, N, mode == "volume", cum0,
                              exit_state=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert same_state(end, want_end)


# a dollar walk is one chunk: walk_warp is its model
MODELS = [("volume", "blocks"), ("volume", "warp"), ("volume", "chunked"),
          ("dollar", "blocks"), ("dollar", "warp")]


@pytest.mark.parametrize("entry", ["zero", "below", "half", "above"])
@pytest.mark.parametrize("mode,model", MODELS)
@pytest.mark.parametrize("name", STREAMS)
def test_models_from_entry_match_plain(name, mode, model, entry):
    x, thr = _values(name, mode)
    cum0 = _entries(thr)[entry]
    want, want_end = fw._walk_plain(torch.from_numpy(x), thr, N, mode == "volume", cum0,
                                    exit_state=True)
    if model == "blocks":
        got, _, end = fw.walk_blocks(x, thr, N, mode == "volume", state=cum0,
                                     exit_state=True)
    elif model == "warp":
        got, _, end = fw.walk_warp(x, thr, N, mode == "volume", state=cum0, exit_state=True)
    else:
        got, st, end = fw.walk_chunked(x, thr, N, 5, state=cum0, exit_state=True)
        assert st["chunks"] > 1
    np.testing.assert_array_equal(got, want.numpy())
    assert same_state(end, want_end)


def _units_walk(x, thr, cum0, lo, hi, first):
    """The units route over x[lo:hi]: kernel E's chunked volume model on the
    values in units of the exact-sum case, from the entry sum in units."""
    u = fw.exact_unit(x, thr)
    units = torch.from_numpy(np.asarray([math.ldexp(v, -u) for v in x[lo:hi]], np.int64))
    carry = int(cum0 / 2.0 ** u) if first else 0
    got, _, end = es._chunked_scan_model(es._VOLUME, hi - lo, 0 if first else 1, N, 3,
                                         units=units, thr=fw.units_threshold(thr, u),
                                         entry=(carry,), exit_state=True)
    return got.numpy(), math.ldexp(float(end[0]), u)


# the dollar walk has one chunk and no units route
ROUTES = [("volume", r) for r in ("plain", "blocks", "warp", "chunked", "units")] + [
    ("dollar", r) for r in ("plain", "blocks", "warp")]


@pytest.mark.parametrize("k", [1, 767, 768, 2 * 768 + 1, "close", 4_001])
@pytest.mark.parametrize("mode,route", ROUTES)
def test_split_stream_equals_whole(mode, route, k):
    """The stream walked as [0, k) and then [k, N) from the exit sum gives the
    whole walk's closes and exit sum, on every route (the exact eighths for
    the units route, the off-grid draws for the others)."""
    x, thr = _values("exact" if route == "units" else "synth0", mode)
    reset = mode == "volume"

    def walk(lo, hi, cum0):
        xs = x[lo:hi]
        if route == "plain":
            got, end = fw._walk_plain(torch.from_numpy(xs), thr, N, reset, cum0,
                                      exit_state=True)
            return got.numpy(), end
        if route == "units":
            return _units_walk(x, thr, cum0, lo, hi, cum0 is not None)
        if route == "blocks":
            got, _, end = fw.walk_blocks(xs, thr, N, reset, state=cum0, exit_state=True)
        elif route == "warp":
            got, _, end = fw.walk_warp(xs, thr, N, reset, state=cum0, exit_state=True)
        else:
            got, _, end = fw.walk_chunked(xs, thr, N, 4, state=cum0, exit_state=True)
        return got, end

    whole, w_end = walk(0, N, None)
    assert len(whole) > 4
    if k == "close":
        k = int(whole[len(whole) // 2]) + 1
    a, mid = walk(0, k, None)
    b, end = walk(k, N, mid)
    np.testing.assert_array_equal(np.concatenate([a, b + k]), whole)
    assert same_state(end, w_end)


def test_route_of_an_entry_sum():
    """The route pass's three numbers and the entry sum pick the route: the
    units route takes an entry sum that is a whole number of the unit (one
    more value), the warp step any other finite sum >= 0, the block walk a
    negative or non-finite one."""
    v = np.array([0.5, 0.25, 1.0, 3.0])                 # units of 2^-2
    low = int(math.frexp(0.25)[1] - 1)
    top = int(np.float64(3.0).view(np.int64))
    vol, dol = fw._VOLUME, fw._DOLLAR
    assert fw.route_of(vol, 0, low, top, 2.0) == (fw.UNITS, -2)
    assert fw.route_of(vol, 0, low, top, 2.0, 1.75) == (fw.UNITS, -2)
    assert fw.route_of(vol, 0, low, top, 2.0, 0.125) == (fw.UNITS, -3)  # a finer unit
    assert fw.route_of(vol, 0, low, top, 2.0, 2.0 ** -60) == (fw.WARP, None)
    assert fw.route_of(vol, 0, low, top, 2.0, float(np.nextafter(2.0, 0))) == (fw.WARP, None)
    assert fw.route_of(dol, 0, low, top, 2.0, 1.75) == (fw.WARP, None)
    for bad in (-1.0, float("nan"), float("inf"), -0.0 - 1e-300):
        assert fw.route_of(vol, 0, low, top, 2.0, bad) == (fw.BLOCK, None)
    assert fw.route_of(vol, 1, low, top, 2.0, 1.0) == (fw.BLOCK, None)
    assert fw.route_of(vol, 0, 1 << 62, 0, 2.0, 1.0) == (fw.UNITS, 0)   # no value > 0
    assert fw.route_of(vol, 0, 1 << 62, 0, 2.0) == (fw.WARP, None)
    assert fw.exact_unit(v, 2.0) == -2
