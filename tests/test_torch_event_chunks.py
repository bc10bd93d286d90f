"""Kernel E's chunked walk, modelled on the CPU (``ops/event_scan.py
_chunked_scan_model``), against the sequential plain scans, close for close.

The model cuts the stream into chunks of whole 2048-trade tiles, walks every
chunk from a guessed state, walks each again from its predecessor's end state
until the two walks meet bit for bit, and fixes up serially what never meets:
the scheme of ``csrc/event_scan.cu``. Its walker restarts its float sums at
every tile, the plain scans at their own chunks, so the data keep every sum
exact (sides of +-1, integer units, CUSUM returns and thresholds on a grid of
2^-30): then no layout of chunks can move a close, and any difference is the
merge logic's. Every case must match exactly.
"""
import types

import numpy as np
import pytest
import torch

from finmlkit_tpu_torch.ops import event_scan as es
from finmlkit_tpu_torch.testing import assert_exact

N = 60_000
GRID = 2.0 ** -30
CAP = 7
_PLAIN = {}


def _case(mode, scenario, start, seed=3):
    """(model kwargs, plain thunk) for a mode and a scenario; ``start`` slices
    the stream (CUSUM: the scan's own start)."""
    rng = np.random.default_rng(seed)
    n = {"every_trade": 5000, "short": 1500}.get(scenario, N)
    if mode == "cusum":
        rets = rng.integers(-1000, 1001, n) * GRID
        rets[0] = 0.0
        lam = rng.integers(15_000, 30_000, n) * GRID
        cc = rng.random(n) < 0.9
        if scenario == "burst":
            rets[30_000:30_500] = 2.0 ** -16     # a close every few trades
        if scenario == "short":
            lam = lam / 4
        if scenario == "every_trade":
            rets = np.where(rng.random(n) < 0.5, 1.0, -1.0) * rng.integers(1, 5, n) * GRID
            lam, cc = np.full(n, GRID), np.ones(n, bool)
        r, lm, c = (torch.from_numpy(a) for a in (rets, lam, cc))
        kw = dict(x=r, lam=lm, can_close=c, start=start + 1, n=n)
        return kw, lambda mb: es.cusum_scan_plain(r, lm, c, start, mb)
    if mode == "volume":
        units = rng.integers(0, 1000, n)
        thr = 100_000
        if scenario == "burst":
            units[30_000:30_500] = thr           # a close on every trade
        if scenario == "every_trade":
            units, thr = rng.integers(1, 1000, n), 1
        u = torch.from_numpy(units[start:]).to(torch.int64)
        kw = dict(units=u, thr=thr, start=1, n=n - start)
        return kw, lambda mb: es.volume_scan_plain(u, thr, mb) + start
    run = mode == "run"
    sides = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    e_t, e_r, a_t, a_r = 1.0, (200.0 if run else 30.0), 0.0, 0.0
    if scenario == "burst":
        sides[30_000:30_500] = 1.0               # a close every theta trades
        e_r = 8.0
    if scenario in ("every_trade", "short"):
        e_r = 1.0 if scenario == "every_trade" else 10.0
    if scenario == "ema":
        e_t, e_r, a_t, a_r = 1000.0, (0.5 if run else 0.03), 0.05, 0.05
    w = torch.from_numpy(sides[start:])
    kw = dict(x=w, e_t=e_t, e_r=e_r, alpha_t=a_t, alpha_r=a_r, start=1,
              n=n - start)
    return kw, lambda mb: es.info_scan_plain(w, e_t, e_r, a_t, a_r, mb, run) + start


MODES = {"cusum": es._CUSUM, "imbalance": es._IMBALANCE, "run": es._RUN,
         "volume": es._VOLUME}
CASES = [(m, "base", p, s, cap) for m in MODES for p in (1, 2, 3, 16)
         for s in (0, 4097) for cap in (False, True)]
CASES += [(m, "burst", p, 0, False) for m in MODES for p in (3, 16)]
CASES += [(m, "every_trade", p, 0, False) for m in MODES for p in (3, 16)]
CASES += [(m, "ema", p, 0, False) for m in ("imbalance", "run") for p in (2, 3, 16)]
CASES += [(m, "short", 16, 0, False) for m in MODES]


@pytest.mark.parametrize("mode,scenario,chunks,start,capped", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_chunked_model_matches_plain(mode, scenario, chunks, start, capped):
    kw, plain = _case(mode, scenario, start)
    n, first = kw.pop("n"), kw.pop("start")
    mb = CAP if capped else n
    key = (mode, scenario, start, mb)
    if key not in _PLAIN:
        _PLAIN[key] = plain(mb)
    want = _PLAIN[key]
    got, stats = es._chunked_scan_model(MODES[mode], n, first, mb, chunks, **kw)
    shift = start if mode != "cusum" else 0
    assert_exact(got + shift, want, f"{mode} {scenario} chunks={chunks}")
    assert len(want) == (CAP if capped else len(want)) and len(want) > 0
    tiles = -(-(n - first) // es._TILE)
    assert stats["tiles"] == tiles
    assert stats["chunks"] == min(chunks, tiles) or chunks > tiles // 2
    if scenario == "ema":        # thresholds that never agree: no walk merges,
        # and pass 2 already walked chunk 1 from its true entry state
        assert stats["unmerged"] == stats["chunks"] - 1
        assert stats["fixed"] == stats["chunks"] - 2
    if scenario == "short":
        assert stats["chunks"] == 1


@pytest.mark.parametrize("mode,want", [("cusum", 528), ("volume", 33),
                                       ("imbalance", 1), ("run", 1)])
def test_default_chunks(monkeypatch, mode, want):
    """Kernel E's default chunk count on a card of 132 multiprocessors: the
    CUSUM and volume walks merge and run chunked; imbalance and run walk
    sequentially, whatever their alphas."""
    props = types.SimpleNamespace(multi_processor_count=132)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
    assert es._default_chunks(MODES[mode], torch.device("cuda")) == want
