"""The cell ``infobars.event-scans`` end to end at a tiny size on the CPU: the
port agrees with the plain reference, every metric of the mode is read, and
the control and the planted faults come out not correct. Each of the
reference's jumping scans equals a literal loop over the trades of the rule
it states."""
import math
import time

import numpy as np
import pytest

import control
import harness
import judge
import month
from refbase import Precision, RefRun
from test_bench_nojax import REFERENCE_ONLY, _tops

CELL = "infobars.event-scans"
KINDS = ("tick", "volume", "cusum", "imbalance", "run")
TINY = 200_000          # trades: about 4 hours; 200 tick, about 200 volume, 55 CUSUM bars
SEED = 2**31 + 77       # larger than 32 signed bits hold


def cell():
    return harness.Cell(CELL, harness.load_json(harness.SPEC))


def run(trace=False, seed=SEED):
    return harness.run_cell(CELL, seed, 0.2, trace, "cpu", time.perf_counter(),
                            n_trades=TINY, log=lambda line: None)


@pytest.fixture
def short_profile(monkeypatch):
    """The traced passes cut to their least, 3: the plain scans' host loops
    give the CPU profiler some 40,000 operations a pass."""
    import profile_trace
    traced = profile_trace.traced_passes
    monkeypatch.setattr(profile_trace, "traced_passes",
                        lambda run_pass, seconds, cuda: traced(run_pass, 0.0, cuda))


@pytest.mark.parametrize("trace", (False, True))
def test_cell_runs_correct(trace, short_profile):
    res = run(trace)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert res["checks"]["mismatches"]["value"] == 0
    want = {m["name"] for m in cell().metrics[trace]}
    # the device metrics (peak memory) are read on a card only
    assert set(res["metrics"]) == want - {"peak_mem_gib"}
    assert all(v["value"] > 0 for v in res["metrics"].values()), res["metrics"]
    if trace:
        assert set(res["metrics"]) == {
            "device_idle_share", "volume_index_ms", "cusum_index_ms", "imbalance_index_ms",
            "run_index_ms", "event_products_ms", "event_scans_roofline", "event_host_ms",
            "event_syncs_per_pass"}
        assert 0 < res["metrics"]["event_scans_roofline"]["value"] <= 100
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0


def test_every_kind_is_judged():
    """Each kind's closes and products reach the judge under their own
    names, in the groups of the other cells."""
    c = cell()
    m = month.synthesize(c.config["assumed"]["month"], SEED, "cpu", 30_000)
    want, _ = harness.reference_outputs(c, m, month.thresholds(m, c.config["settings"]), "cpu")
    for kind in KINDS:
        assert want[f"{kind}.ci"].shape[0] >= 3
        for col in ("close", "vwap", "volume", "trades"):
            assert f"ohlcv.{kind}.{col}" in want
        assert f"directional.{kind}.ticks_buy" in want
    nums = judge.compare(want, want)
    assert set(nums) == {"mismatches", "ohlcv_f64", "ohlcv_f32", "directional_f32"}
    assert set(nums) == set(c.limits)


def test_control_is_not_correct():
    c = cell()
    for seed in (1, 2, 3):
        nums = control.control(c, seed, "cpu", TINY)
        assert not judge.verdict(nums, c.limits), nums


def _fault_close(fn):
    def broken(*a, **kw):
        got = list(fn(*a, **kw))
        ci = got[1].clone()
        ci[len(ci) // 2] += 1
        got[1] = ci
        return tuple(got)
    return broken


INDEXERS = {"tick": ("tick_index", "tick_bar_indexer"),
            "volume": ("volume_index", "volume_bar_indexer_q"),
            "cusum": ("cusum_index", "cusum_bar_indexer"),
            "imbalance": ("imbalance_index", "imbalance_bar_indexer"),
            "run": ("run_index", "run_bar_indexer")}


@pytest.mark.parametrize("kind", KINDS)
def test_a_moved_close_is_not_correct(kind, monkeypatch):
    step, attr = INDEXERS[kind]
    mod = harness.module(harness.BENCH_DIR, "steps", step)
    monkeypatch.setattr(mod, attr, _fault_close(getattr(mod, attr)))
    res = run()
    assert res["correct"] is False and res["failed"] == 1, res["checks"]
    assert res["checks"]["mismatches"]["value"] > 0


def test_an_altered_vwap_in_one_set_is_not_correct(monkeypatch):
    """The VWAP of one bar of the CUSUM bars (the third products call of
    each pass) moved by a millionth."""
    mod = harness.module(harness.BENCH_DIR, "steps", "bar_products")
    fn, calls = mod.bar_products_final, [0]

    def broken(*a, **kw):
        ohlcv, directional = fn(*a, **kw)
        calls[0] += 1
        if calls[0] % len(KINDS) == 3:
            ohlcv["vwap"] = ohlcv["vwap"].clone()
            ohlcv["vwap"][len(ohlcv["vwap"]) // 2] *= 1 + 1e-6
        return ohlcv, directional
    monkeypatch.setattr(mod, "bar_products_final", broken)
    res = run()
    assert res["correct"] is False and res["failed"] == 1, res["checks"]
    assert res["checks"]["mismatches"]["value"] == 0
    assert res["checks"]["ohlcv_f64"]["value"] > res["checks"]["ohlcv_f64"]["limit"]


def test_the_reference_imports_nothing_of_the_program():
    res = _tops(REFERENCE_ONLY.format(bench=str(harness.BENCH_DIR), cell=CELL))
    assert not {"finmlkit_tpu_torch", *harness.FORBIDDEN} & set(res["tops"])


# --- the jumping references against literal loops of their rules ----------------


def loop_tick(n, t):
    out, count = [0], 1                  # trade 0 counts in the first bar
    for i in range(1, n):
        count += 1
        if count >= t:
            out.append(i)
            count = 0
    return out


def loop_volume(units, thr):
    out, s = [0], int(units[0])          # the sum starts with trade 0's units
    for i in range(1, len(units)):
        s += int(units[i])
        if s >= thr:
            out.append(i)
            s = 0
    return out


def loop_imbalance(side, theta):
    out, s = [0], 0
    for i in range(1, len(side)):
        s += int(side[i])
        if abs(s) >= theta:
            out.append(i)
            s = 0
    return out


def loop_run(side, e_t, e_r, a_t, a_r):
    out, b, s, opened = [0], 0.0, 0.0, 0
    for i in range(1, len(side)):
        if side[i] > 0:
            b += 1.0
        elif side[i] < 0:
            s += 1.0
        stat = max(b, s)
        if stat >= e_t * e_r:
            t_bar = float(i - opened)
            rate = stat / max(t_bar, 1.0)
            e_t = (1 - a_t) * e_t + a_t * t_bar
            e_r = (1 - a_r) * e_r + a_r * rate
            out.append(i)
            b = s = 0.0
            opened = i
    return out


def loop_cusum(rets, can_close, lam):
    """The closes, and for each the side that fired and whether its sum had
    crossed at an earlier trade that could not close (in a same-timestamp
    block)."""
    out, sides, held = [0], [], []
    sp = sn = 0.0
    crossed_at = None
    for i in range(1, len(rets)):
        sp, sn = sp + float(rets[i]), sn + float(rets[i])
        sp, sn = (0.0 if sp < 0.0 else sp), (0.0 if sn > 0.0 else sn)
        over = sp >= lam or sn <= -lam
        if over and crossed_at is None:
            crossed_at = i
        if can_close[i] and sp >= lam:
            out.append(i)
            sides.append("+")
            sp = 0.0
        elif can_close[i] and sn <= -lam:
            out.append(i)
            sides.append("-")
            sn = 0.0
        else:
            continue
        held.append(crossed_at < i)
        crossed_at = None if not (sp >= lam or sn <= -lam) else i
    return out, sides, held


def _ref(seed, n, kind, params, blocks=0.0):
    """The reference's closes of ``kind`` on the month of ``seed`` cut to
    ``n`` trades (a share ``blocks`` of the trades given the timestamp of
    the trade before), and its run state."""
    c = cell()
    m = month.synthesize(c.config["assumed"]["month"], seed, "cpu", n)
    if blocks:
        same = np.random.default_rng(seed).random(n) < blocks
        same[0] = False
        keep = np.maximum.accumulate(np.where(same, 0, np.arange(n)))
        m.ts = m.ts[keep]
    r = RefRun(m, c.config["grid"], {}, "cpu", Precision())
    c.reference(f"{kind}_index").run(r, params)
    return r.out[f"{kind}.ci"].tolist(), r


SEEDS = (2**31 + 11, 7, 2**32 + 5)


def _settings(kind):
    return cell().config["settings"][f"{kind}_index"]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ticks", (1000, 7, 1))
def test_tick_reference_is_the_loop(seed, ticks):
    got, r = _ref(seed, 20_000, "tick", {**_settings("tick"), "ticks": ticks})
    assert got == loop_tick(r.n, ticks)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("threshold", (55.0, 0.5))
def test_volume_reference_is_the_loop(seed, threshold):
    got, r = _ref(seed, 40_000, "volume", {"threshold": threshold})
    want = loop_volume(r.units.numpy(), math.ceil(threshold / r.unit))
    assert got == want and len(want) > 10


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("theta", (30.0, 5.0, 4.5))
def test_imbalance_reference_is_the_loop(seed, theta):
    got, r = _ref(seed, 50_000, "imbalance", {**_settings("imbalance"), "theta": theta})
    want = loop_imbalance(r.side.numpy(), theta)
    assert got == want and len(want) > 10


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("e_t0", (1000.0, 40.0))
def test_run_reference_is_the_loop(seed, e_t0):
    p = {**_settings("run"), "expected_ticks_init": e_t0}
    got, r = _ref(seed, 50_000, "run", p)
    want = loop_run(r.side.numpy(), e_t0, p["expected_rate_init"], p["alpha_ticks"],
                    p["alpha_rate"])
    assert got == want and len(want) > 10


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mult, blocks", [(60.0, 0.0), (60.0, 0.3), (3.0, 0.3), (3.0, 0.6)])
def test_cusum_reference_is_the_loop(seed, mult, blocks):
    p = {**_settings("cusum"), "mult": mult}
    got, r = _ref(seed, 50_000, "cusum", p, blocks)
    lp = np.log(r.price.numpy())
    rets = np.concatenate([[0.0], lp[1:] - lp[:-1]])
    cc = np.append(r.ts.numpy()[:-1] != r.ts.numpy()[1:], True)
    lam = max(p["mult"] * p["sigma"], p["sigma_floor"])
    want, sides, held = loop_cusum(rets, cc, lam)
    assert got == want and len(want) > 5
    assert "-" in sides and "+" in sides          # closes that s- fired alone, and s+
    if blocks:
        assert any(held)          # a crossing held inside a same-timestamp block
    assert 0 < r.aux["cusum_margin"] < lam


# --- the bytes of the four kernel-E stages -------------------------------------


@pytest.mark.parametrize("n, closes, want", [
    (10, 4, 10 * 30 + 4 * 8),
    (39_171_929, 130_000, 39_171_929 * 30 + 130_000 * 8),
])
def test_event_scan_bytes(n, closes, want):
    assert harness.module(harness.BENCH_DIR, "bytecounts", "event_scans").bytes_of(
        n, closes) == want
