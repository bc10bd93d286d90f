"""Each cell end to end at a tiny size on the CPU: the port agrees with the
plain reference, every metric of the mode is read, and the control and the
planted faults come out not correct."""
import time

import pytest

import control
import harness
import judge

CELLS = ("time1m.labels", "infobars.dollar-footprint")
TINY = 200_000          # trades: about 4 hours, 233 one-minute bars or 40,000 dollar bars
SEED = 2**31 + 77       # larger than 32 signed bits hold


def spec():
    return harness.load_json(harness.SPEC)


def run(cell, trace=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.2, trace, "cpu", time.perf_counter(),
                            n_trades=TINY, log=lambda line: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (False, True))
def test_cell_runs_correct(cell, trace):
    res = run(cell, trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in harness.Cell(cell, spec()).metrics[trace]}
    # the device metrics (peak memory) are read on a card only
    assert set(res["metrics"]) == want - {"peak_mem_gib"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    if trace:
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert 1 <= len(res["breakdown"]["device_ops"]) <= 10
        assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_same_seed_same_month():
    import month
    draws = harness.Cell(CELLS[0], spec()).config["assumed"]["month"]
    a, b = (month.synthesize(draws, SEED, "cpu", 10_000) for _ in range(2))
    c = month.synthesize(draws, SEED + 1, "cpu", 10_000)
    for k in ("ts", "price", "amount", "side"):
        assert (getattr(a, k) == getattr(b, k)).all()
    assert not (a.price == c.price).all()


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = harness.Cell(cell, spec())
    for seed in (1, 2, 3):
        nums = control.control(c, seed, "cpu", TINY)
        assert not judge.verdict(nums, c.limits), nums


def _fault_vwap(fn):
    def broken(*a, **kw):
        ohlcv, directional = fn(*a, **kw)
        ohlcv["vwap"] = ohlcv["vwap"].clone()
        ohlcv["vwap"][len(ohlcv["vwap"]) // 2] *= 1 + 1e-6
        return ohlcv, directional
    return broken


def _fault_half(fn):
    def broken(ticks, units, ci, sides, **kw):   # every other trade's units left out
        units = units.clone()
        units[1::2] = 0
        return fn(ticks, units, ci, sides, **kw)
    return broken


def _fault_close(fn):
    def broken(*a, **kw):
        ts, ci = fn(*a, **kw)
        ci = ci.clone()
        ci[len(ci) // 2] += 1
        return ts, ci
    return broken


FAULTS = {   # an answer altered where it is produced; half of the trades left out
    "vwap altered": ("bar_products", "bar_products_final", _fault_vwap),
    "half the trades": ("bar_products", "bar_products_final", _fault_half),
    "close moved": (None, None, _fault_close),
}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    step, attr, make = FAULTS[fault]
    if step is None:
        step, attr = (("time_index", "time_bar_indexer") if cell.startswith("time")
                      else ("dollar_index", "dollar_bar_indexer_q"))
    mod = harness.module(harness.BENCH_DIR, "steps", step)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    res = run(cell)
    assert res["correct"] is False and res["failed"] == 1, res["checks"]
