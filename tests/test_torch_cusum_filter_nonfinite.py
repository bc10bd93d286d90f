"""The port's CUSUM event filter (``sampling/filters.py cusum_filter``) on a
NaN price and on a zero price, against a numpy transcription of the JAX
package's native loop (``finmlkit_tpu/native/seg_stats.cpp:137-151``), and
against that loop itself where the native library builds.

The loop resets a NaN sum to 0 (``sp > 0.0 ? sp : 0.0``) and goes on, so
events continue after the bad price. The JAX package's device form of the
filter (``finmlkit_tpu/sampling/filters.py:18-62``) carries the NaN in its
chunk prefix and emits no event after it (fault R11 in ROADMAP.md); the port
must not follow it there. 6,000 prices, threshold 6e-3, the bad price at
index 1000: the loop emits 703 events after a NaN price and 705 after a zero
price, the last at 5990.
"""
import numpy as np
import pytest
import torch

from finmlkit_tpu import native
from finmlkit_tpu_torch.sampling.filters import cusum_filter

N, THRESHOLD, BAD_AT = 6000, 6e-3, 1000
EXPECTED = {"finite": None, "nan": (703, 5990), "zero": (705, 5990)}


def _prices(bad: str) -> np.ndarray:
    r = np.random.default_rng(0)
    p = 100.0 * np.exp(np.cumsum(r.normal(0.0, 2e-3, N)))
    if bad != "finite":
        p[BAD_AT] = np.nan if bad == "nan" else 0.0
    return p


def _log_returns(p: np.ndarray) -> np.ndarray:
    """As the JAX package hands them to the native loop (filters.py:94-96)."""
    log_ret = np.zeros(len(p))
    with np.errstate(divide="ignore", invalid="ignore"):
        np.log(p[1:] / p[:-1], out=log_ret[1:])
    return log_ret


def _native_loop(log_ret: np.ndarray, thr: np.ndarray) -> np.ndarray:
    """``cusum_filter_events`` (seg_stats.cpp:137-151) in numpy scalars."""
    s_pos = s_neg = 0.0
    events = []
    for i in range(1, len(log_ret)):
        r = log_ret[i]
        sp, sn = s_pos + r, s_neg + r
        s_pos = sp if sp > 0.0 else 0.0
        s_neg = sn if sn < 0.0 else 0.0
        if s_neg < -thr[i]:
            s_neg = 0.0
            events.append(i)
        elif s_pos > thr[i]:
            s_pos = 0.0
            events.append(i)
    return np.asarray(events, np.int64)


@pytest.mark.parametrize("bad", list(EXPECTED))
def test_cusum_filter_continues_past_a_bad_price(bad):
    p = _prices(bad)
    thr = np.full(N, THRESHOLD)
    with np.errstate(divide="ignore", invalid="ignore"):
        got = cusum_filter(torch.from_numpy(p), [THRESHOLD]).numpy()
    want = _native_loop(_log_returns(p), thr)
    np.testing.assert_array_equal(got, want)
    assert (got > BAD_AT).sum() > 500
    if EXPECTED[bad] is not None:
        assert (len(got), int(got[-1])) == EXPECTED[bad]
    built = native.cusum_filter_events(_log_returns(p), thr)
    if built is not None:          # the native library built in this process
        np.testing.assert_array_equal(got, np.asarray(built, np.int64))
