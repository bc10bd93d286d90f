"""Kernel E's count search (mode 5, tick run bars), modelled on the CPU
(``ops/event_scan.py _run_count_model``), against the plain run-bar scan
``info_scan_plain(..., run_mode=True)`` bit for bit: the closes, their count
and the exit state, on sides with and without zeros, at EMA and fixed
thresholds, at thresholds of 0 and below, NaN and infinite, above a chunk of
4096 table entries and above the trades left, with truncation, from whole entry
sums, with trade 0 checked. The model's rings of 2 chunks of 4096 entries are
the kernel's; rings of 1 chunk make a bar of more than 4096 buys or sells
read past them.
Also the route: which scans :func:`event_scan.info_scan` sends to the search.
"""
import math

import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.ops import event_scan as es
from finmlkit_tpu_torch.testing import same_state

# (n, e_t, e_r, alpha_t, alpha_r): every case closes at most a few thousand
# bars, so that the plain scan's host loop stays short
SETTINGS = {
    "ema": (120_000, 1000.0, 0.5, 0.05, 0.05),       # the event cell's EMA
    "ema_fast": (60_000, 100.0, 0.6, 0.2, 0.1),
    "fixed_30": (40_000, 1.0, 30.0, 0.0, 0.0),
    "fixed_30_5": (40_000, 1.0, 30.5, 0.0, 0.0),
    "above_a_chunk": (150_000, 1.0, 5000.5, 0.0, 0.0),  # k 5001: bars of ~10,000 trades
    "above_the_rest": (20_000, 1.0, 1e7, 0.0, 0.0),  # no close
    "theta_0": (3_000, 1.0, 0.0, 0.0, 0.0),          # every trade closes
    "theta_below_0": (3_000, 1.0, -2.5, 0.0, 0.0),
    "theta_nan": (5_000, 1.0, math.nan, 0.0, 0.0),
    "theta_inf": (5_000, 1.0, math.inf, 0.0, 0.0),
    "theta_minus_inf": (3_000, 1.0, -math.inf, 0.0, 0.0),
}


def _sides(n, zeros, seed=0):
    g = np.random.default_rng(seed)
    s = np.where(g.random(n) < 0.5, 1.0, -1.0)
    if zeros:
        s[g.random(n) < zeros] = 0.0
    return torch.from_numpy(s)


def _model(w, args, start=1, mb=None, chunks=es._COUNT_CHUNKS, entry=None):
    n, e_t, e_r, a_t, a_r = len(w), *args
    return es._run_count_model(n, start, n if mb is None else mb, x=w, e_t=e_t, e_r=e_r,
                               alpha_t=a_t, alpha_r=a_r, chunks=chunks, entry=entry,
                               exit_state=True)


@pytest.mark.parametrize("chunks", [es._COUNT_CHUNKS, 1])
@pytest.mark.parametrize("zeros", [0.0, 0.3], ids=["sides", "zeros"])
@pytest.mark.parametrize("name", list(SETTINGS))
def test_model_matches_plain(name, zeros, chunks):
    n, *args = SETTINGS[name]
    w = _sides(n, zeros)
    got, stats, end = _model(w, args, chunks=chunks)
    want, want_end = es.info_scan_plain(w, *args, n, True, exit_state=True)
    assert torch.equal(got, want), (len(got), len(want))
    assert stats["closes"] == len(want)
    assert same_state(end, want_end), (end, want_end)
    if name.startswith("theta_") and name != "theta_nan" and name != "theta_inf":
        assert len(want) == n - 1 and stats["next"] == n - 1
    if name in ("above_the_rest", "theta_nan", "theta_inf"):
        assert len(want) == 0
    if name == "above_a_chunk":
        assert len(want) > 5 and (chunks > 1 or stats["misses"] > 5)


@pytest.mark.parametrize("mb", [1, 7, 50])
@pytest.mark.parametrize("name", ["ema", "fixed_30"])
def test_truncation_keeps_the_count_and_the_exit_state(name, mb):
    """Only the first ``max_bars`` closes are kept, but every close is
    counted and the exit state is the stream's end, as the walk's."""
    n, *args = SETTINGS[name]
    w = _sides(n, 0.0, seed=1)
    got, stats, end = _model(w, args, mb=mb)
    assert torch.equal(got, es.info_scan_plain(w, *args, mb, True))
    assert stats["closes"] == len(es.info_scan_plain(w, *args, n, True))
    walk, _, walk_end = es._chunked_scan_model(es._RUN, n, 1, mb, 1, x=w, e_t=args[0],
                                               e_r=args[1], alpha_t=args[2],
                                               alpha_r=args[3], exit_state=True)
    assert torch.equal(got, walk)
    assert same_state(end, walk_end), (end, walk_end)


# entry states (cb, cs, E[T], E[rate], open) at fixed theta 30 or the EMA,
# with trade 0 checked: a sum one below theta, at it, above it, both sides
# high, a sum that makes the first bar long, an open before the stream
ENTRIES = {
    "one_below": ((29.0, 3.0, 1.0, 30.0, -7), (0.0, 0.0)),
    "at_theta": ((30.0, 0.0, 1.0, 30.0, -1), (0.0, 0.0)),
    "above_theta": ((45.0, 2.0, 1.0, 30.0, -3), (0.0, 0.0)),
    "both_high": ((29.0, 29.0, 1.0, 30.0, -12_345), (0.0, 0.0)),
    "negative": ((-900.0, 0.0, 1.0, 30.0, -5), (0.0, 0.0)),
    "ema_open": ((480.0, 399.0, 1000.0, 0.5, -12_345), (0.05, 0.05)),
    "minus_zero": ((-0.0, -0.0, 1000.0, 0.5, 0), (0.05, 0.05)),
}


@pytest.mark.parametrize("first", [True, False], ids=["trade0_checked", "trade0_open"])
@pytest.mark.parametrize("name", list(ENTRIES))
def test_entry_states_match_plain(name, first):
    entry, alphas = ENTRIES[name]
    n = 30_000
    w = _sides(n, 0.1, seed=2)
    args = (entry[2], entry[3], *alphas)
    got, stats, end = _model(w, args, start=0 if first else 1, entry=entry)
    want, want_end = es.info_scan_plain(w, *args, n, True, state=entry, first_closes=first,
                                        exit_state=True)
    assert torch.equal(got, want)
    assert same_state(end, want_end), (end, want_end)
    if name in ("at_theta", "above_theta"):
        assert stats["next"] >= 1 and int(want[0]) == (0 if first else 1)


@pytest.mark.parametrize("where,flagged", [(0, False), (1, True), (29_999, True)])
def test_a_weight_outside_minus_one_to_one_is_flagged(where, flagged):
    """A weight of 2 among the checked trades sets the pack's flag (the
    model returns None); trade 0, before the checks, is not looked at."""
    w = _sides(30_000, 0.0)
    w[where] = 2.0
    got = _model(w, SETTINGS["fixed_30"][1:])
    assert (got is None) == flagged
    if not flagged:
        assert torch.equal(got[0], es.info_scan_plain(w, 1.0, 30.0, 0.0, 0.0, 30_000, True))


@pytest.mark.parametrize("bad", [0.5, -1.5, math.nan, math.inf, -math.inf])
def test_any_other_weight_is_flagged(bad):
    w = _sides(5_000, 0.2)
    w[2_500] = bad
    assert _model(w, SETTINGS["fixed_30"][1:]) is None


ROUTES = {   # (run_mode, integral, entry sums, n) -> the count search
    "tick_run": ((True, True, (0.0, 0.0), 100), True),
    "whole_entry": ((True, True, (29.0, -3.0), 100), True),
    "minus_zero": ((True, True, (-0.0, 0.0), 100), True),
    "largest_entry": ((True, True, (2.0 ** 52, 0.0), 100), True),
    "not_integral": ((True, False, (0.0, 0.0), 100), False),
    "imbalance": ((False, True, (0.0, 0.0), 100), False),
    "fractional_cb": ((True, True, (0.5, 0.0), 100), False),
    "fractional_cs": ((True, True, (0.0, 7.25), 100), False),
    "nan_entry": ((True, True, (math.nan, 0.0), 100), False),
    "inf_entry": ((True, True, (0.0, math.inf), 100), False),
    "huge_entry": ((True, True, (2.0 ** 53, 0.0), 100), False),
    "long_stream": ((True, True, (0.0, 0.0), 2 ** 31), False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_the_route(name):
    (run_mode, integral, sums, n), want = ROUTES[name]
    assert es._count_route(run_mode, integral, (*sums, 1000.0, 0.5, 0), n) is want


def test_cpu_tensors_take_the_plain_scan():
    """On the CPU ``info_scan`` is the plain scan whatever the route."""
    n, *args = SETTINGS["ema"]
    w = _sides(n, 0.0, seed=3)
    assert torch.equal(es.info_scan(w, *args, n, True, integral=True),
                       es.info_scan_plain(w, *args, n, True))
