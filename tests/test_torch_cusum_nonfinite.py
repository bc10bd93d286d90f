"""The CUSUM scans on non-finite returns and thresholds, held close for close
to the reference's exact host loop (``finmlkit_tpu/native/seg_stats.cpp:
159-176``) transcribed to numpy (``testing.cusum_recurrence``): the port's
plain path (``cusum_scan_plain``, chunked closed forms cut at each
non-finite return) and kernel E's chunked walk modelled on the CPU
(``_chunked_scan_model``) at one chunk and several, and the oracle itself to
the native host loop where that library builds.

Finite returns and thresholds lie on a grid of 2^-30, so every sum is exact
and no layout of chunks can move a close: any difference is the handling of
the non-finite inputs. A NaN return makes both sums NaN for good; -inf then
+inf with no close between (a zero price inside one same-timestamp block)
makes only s- NaN, and s+ closes on; a NaN ``lam`` never closes.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu import native
from finmlkit_tpu_torch.ops import event_scan as es
from finmlkit_tpu_torch.testing import (CUSUM_BAD, assert_exact, cusum_bad_inputs,
                                       cusum_recurrence)

N = 20_000
AT = 5000                 # where the bad input goes (testing.cusum_bad_inputs)
FIRST = 1                 # the scan starts at trade start + 1 = 1


def _case(name):
    return cusum_bad_inputs(name, N, AT)


CASES = list(CUSUM_BAD)
_ORACLE = {}


def _oracle(name):
    if name not in _ORACLE:
        rets, lam, cc, _ = _case(name)
        _ORACLE[name] = cusum_recurrence(rets, lam, cc, 0)
    return _ORACLE[name]


def _torch(name):
    return tuple(torch.from_numpy(a) for a in _case(name)[:3])


def _closes_of_base():
    rets, lam, cc, _ = _case("nan")
    rets[AT] = 0.0
    return cusum_recurrence(rets, lam, cc, 0)


def test_oracle_semantics():
    """The recurrence's own consequences, on the cases: closes stop for good
    after a NaN return; an infinite return closes at once and closes go on;
    in one same-timestamp block -inf then +inf leaves s+ at +inf, to close at
    the block's end, and s- NaN, so later bars close on s+ alone (fewer of
    them); a NaN lam never closes, an infinite one neither here."""
    base = _closes_of_base()
    assert len(base) > 100
    for name in ("nan", "nan_tile_last", "nan_tile_first", "nan_segment_last"):
        want = _oracle(name)
        bad = int(np.flatnonzero(np.isnan(_case(name)[0]))[0])
        assert len(want) > 3 and want[-1] < bad, name
    for name, at in (("inf", [AT]), ("-inf", [AT]), ("zero_price", [AT, AT + 1])):
        want = _oracle(name)
        assert set(at) <= set(want) and want[-1] > AT + 1000, name
    want = _oracle("zero_price_block")
    assert AT not in want and AT + 1 not in want and AT + 2 in want
    later, base_later = want[want > AT + 2], base[base > AT + 2]
    assert 10 < len(later) < 0.75 * len(base_later)
    for name in ("nan_lam", "nan_and_inf_lam"):
        want = _oracle(name)
        assert not np.any((want >= AT) & (want < AT + 300)) and want[-1] > AT + 300, name


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_recurrence(name):
    rets, lam, cc = _torch(name)
    assert_exact(es.cusum_scan_plain(rets, lam, cc, 0, N), _oracle(name), name)


@pytest.mark.parametrize("name", CASES)
def test_plain_max_bars_matches_recurrence(name):
    rets, lam, cc = _torch(name)
    for cap in (1, 40):
        assert_exact(es.cusum_scan_plain(rets, lam, cc, 0, cap), _oracle(name)[:cap],
                     f"{name} max_bars={cap}")


@pytest.mark.parametrize("chunks", [1, 3, 10])
@pytest.mark.parametrize("name", CASES)
def test_chunked_model_matches_recurrence(name, chunks):
    """Kernel E's chunked walk (modelled): chunk 0 from the initial state,
    the others from a guess, merged where walks meet bit for bit; a NaN state
    never meets a finite one, so the fix-up walks on from it."""
    rets, lam, cc = _torch(name)
    got, stats = es._chunked_scan_model(es._CUSUM, N, FIRST, N, chunks, x=rets,
                                        lam=lam, can_close=cc)
    assert_exact(got, _oracle(name), f"{name} chunks={chunks}")
    assert stats["chunks"] == min(chunks, -(-(N - FIRST) // es._TILE))


@pytest.mark.parametrize("name", CASES)
def test_recurrence_matches_host_loop(name):
    """The numpy transcription against the native host loop it transcribes
    (the JAX package's ``native.cusum_bar_boundaries``), where the library
    builds; without it, the oracle stands on its transcription alone."""
    rets, lam, _, ts = _case(name)
    got = native.cusum_bar_boundaries(rets, lam, ts, 0, N)
    if got is not None:
        assert_exact(_oracle(name), got, name)
