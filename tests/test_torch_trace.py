"""The trace registry (``finmlkit_tpu_torch/utils/trace.py``) on the CPU:
spans nest, reads and counters go to the innermost span, tracing off opens
no profiler range and tracing on encloses the entry's operations, ``dump``
writes the spans, each benchmarked entry and each event indexer opens its
span once a call with its reads counted, a full close buffer counts its
regrowth, and no former launch counter is left beside the registry."""
import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import finmlkit_tpu_torch
from finmlkit_tpu_torch import interop
from finmlkit_tpu_torch.bar.aggregate_q import bar_trade_size_features
from finmlkit_tpu_torch.bar.footprint_q import bar_footprints
from finmlkit_tpu_torch.bar.fused import bar_products_final
from finmlkit_tpu_torch.bar.indexers import (cusum_bar_indexer, dollar_bar_indexer_q,
                                              imbalance_bar_indexer, run_bar_indexer,
                                              tick_bar_indexer, time_bar_indexer,
                                              volume_bar_indexer_q)
from finmlkit_tpu_torch.bar.quantize import quantize_trades
from finmlkit_tpu_torch.label.tbm import triple_barrier
from finmlkit_tpu_torch.label.weights import average_uniqueness, return_attribution
from finmlkit_tpu_torch.sampling.filters import cusum_filter
from finmlkit_tpu_torch.utils import trace

PACKAGE = Path(finmlkit_tpu_torch.__file__).resolve().parent


@pytest.fixture
def registry():
    """A fresh registry, with tracing off and left as it was found."""
    was_on = trace.enabled()
    trace.disable()
    trace.reset()
    yield trace
    trace.reset()
    (trace.enable if was_on else trace.disable)()


def test_spans_nest(registry):
    trace.enable()

    @trace.span("outer")
    def outer():
        with trace.span("inner"):
            pass
        with trace.span("inner"):
            pass

    for _ in range(3):
        outer()
    rows = _dump(registry)
    assert [r["name"] for r in rows[:3]] == ["inner", "inner", "outer"]
    calls = [r["call"] for r in rows]
    assert calls == sorted(calls) and len(set(calls)) == 3     # one id a top-level call
    for r in rows:
        if r["name"] == "inner":
            host = next(o for o in rows if o["name"] == "outer" and o["call"] == r["call"])
            assert r["parent"] == "outer"
            assert host["start_ns"] <= r["start_ns"] <= r["end_ns"] <= host["end_ns"]
        else:
            assert r["parent"] is None
    rep = trace.report()
    o, i = rep["outer"], rep["inner"]
    assert (o["calls"], o["top"], o["timed"]) == (3, 3, 2)      # the first call apart
    assert (i["calls"], i["top"], i["timed"]) == (6, 0, 5)
    assert o["first_ms"] > o["self_first_ms"] > 0
    assert o["host_ms"] > o["self_host_ms"] > 0             # the inner spans' time apart
    assert i["self_host_ms"] == i["host_ms"] > 0
    assert o["device_ms"] is None                  # no card: no events


def test_reads_and_counts_go_to_the_innermost_span(registry):
    with trace.span("entry"):
        assert trace.host_read(int, torch.tensor(7)) == 7
        trace.host_read(int, torch.tensor(1), n=2)    # a call that reads twice
        trace.count("launch.X")
        with trace.span("step"):
            trace.host_read(float, torch.tensor(1.5))
            trace.host_read(float, torch.tensor(2.5))
            trace.count("launch.X")
            trace.count("launch.X.mode", 2)
            trace.count("other")
    trace.count("launch.X")                        # outside every span: the process only
    rep = trace.report()
    e, s = rep["entry"], rep["step"]
    assert (e["reads"], e["self_reads"], s["reads"], s["self_reads"]) == (5, 3, 2, 2)
    assert e["launches"] == {"launch.X": 2, "launch.X.mode": 2}
    assert e["self_launches"] == {"launch.X": 1}
    assert s["launches"] == s["self_launches"] == {"launch.X": 1, "launch.X.mode": 2}
    assert e["counts"] == s["self_counts"] == {"other": 1} and e["self_counts"] == {}
    assert trace.counter("launch.X") == 3 and trace.counter("launch.X.mode") == 2
    assert trace.counter("launch.never") == 0


def test_a_read_outside_every_span_counts_nowhere(registry):
    assert trace.host_read(int, torch.tensor(3)) == 3
    with trace.span("entry"):
        pass
    assert trace.report()["entry"]["reads"] == 0


@pytest.mark.parametrize("form", ["with", "decorator"])
def test_a_span_closes_when_its_block_raises(registry, form):
    def fail():
        raise KeyError("x")
    with pytest.raises(KeyError):
        if form == "with":
            with trace.span("entry"):
                fail()
        else:
            trace.span("entry")(fail)()
    with trace.span("next"):
        trace.host_read(int, torch.tensor(1))
    rep = trace.report()
    assert rep["entry"]["calls"] == 1
    assert (rep["next"]["top"], rep["next"]["reads"], rep["entry"]["reads"]) == (1, 1, 0)


def test_profiled_calls_count_but_add_no_host_time(registry):
    for _ in range(2):
        with trace.span("entry"):
            trace.host_read(int, torch.tensor(1))
    before = trace.report()["entry"]
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("entry"):
            trace.host_read(int, torch.tensor(1))
    after = trace.report()["entry"]
    assert (after["calls"], after["reads"]) == (3, 3)
    assert (after["timed"], after["host_ms"], after["read_ms"]) == \
        (before["timed"], before["host_ms"], before["read_ms"])


def test_reset_forgets_everything(registry):
    trace.enable()
    with trace.span("entry"):
        trace.count("launch.X")
    trace.reset()
    assert trace.report() == {} and trace.counter("launch.X") == 0
    with trace.span("entry"):
        pass
    assert trace.report()["entry"]["timed"] == 0          # the first call again


def test_dump_writes_one_line_a_span(registry, tmp_path):
    with trace.span("off"):          # tracing off: no record
        pass
    trace.enable()
    for _ in range(2):
        with trace.span("a"):
            with trace.span("b"):
                pass
    path = tmp_path / "spans.jsonl"
    assert trace.dump(path) == 4
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["name"] for r in rows] == ["b", "a", "b", "a"]
    assert set(rows[0]) == {"name", "parent", "call", "start_ns", "end_ns"}


def _dump(registry):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "spans.jsonl"
        registry.dump(p)
        return [json.loads(line) for line in p.read_text().splitlines()]


# --- the benchmarked entries on small CPU inputs ---------------------------------

N_TRADES = 6000


def _trades():
    rng = np.random.default_rng(5)
    ts = (1_700_000_000_000_000_000 + np.cumsum(rng.integers(1, 4, N_TRADES)) * 1_000_000_000
          ).astype(np.int64)
    price = np.round(30_000 + np.cumsum(rng.normal(0, 2, N_TRADES)), 1)
    amount = np.round(rng.exponential(0.05, N_TRADES) + 0.001, 3).astype(np.float32)
    side = np.where(rng.random(N_TRADES) < 0.5, 1, -1).astype(np.int8)
    q = quantize_trades(price, amount)
    return interop.from_numpy(q, None, side, amount, "cpu", timestamps=ts)


@pytest.fixture(scope="module")
def pass_inputs():
    """One pass of each cell's entries: the time bars' chain and the dollar
    bars' order flow, their inputs and outputs kept by entry."""
    tr = _trades()
    clock, ci_t = time_bar_indexer(tr.timestamps, 60.0)
    ohlcv_t, _ = bar_products_final(tr.ticks, tr.units, ci_t, tr.sides, tick_size=tr.tick_size,
                                    amount_scale=tr.amount_scale, amounts_f32=tr.amounts)
    close = ohlcv_t["close"]
    events = cusum_filter(close, [0.0005])
    events = events[events < close.shape[0] - 10]
    if events.shape[0] == 0:
        events = torch.arange(5, close.shape[0] - 10, 7)
    bar_ts = clock[1:ci_t.shape[0]]
    targets = torch.full((events.shape[0],), 0.001, dtype=torch.float64)
    labels = triple_barrier(bar_ts, close, events, targets, (1, 1), 600.0)
    _, conc = average_uniqueness(bar_ts, events, labels[1])
    dollar = float((tr.amounts.double() * tr.ticks.double() * tr.tick_size).sum()) / 40
    _, ci_d = dollar_bar_indexer_q(tr.timestamps, tr.ticks, tr.units, dollar, tr.tick_size,
                                   tr.amount_scale)
    ohlcv_d, _ = bar_products_final(tr.ticks, tr.units, ci_d, tr.sides, tick_size=tr.tick_size,
                                    amount_scale=tr.amount_scale, amounts_f32=tr.amounts)
    return {
        "time_bar_indexer": lambda: time_bar_indexer(tr.timestamps, 60.0),
        "dollar_bar_indexer_q": lambda: dollar_bar_indexer_q(
            tr.timestamps, tr.ticks, tr.units, dollar, tr.tick_size, tr.amount_scale),
        "bar_products_final": lambda: bar_products_final(
            tr.ticks, tr.units, ci_d, tr.sides, tick_size=tr.tick_size,
            amount_scale=tr.amount_scale, amounts_f32=tr.amounts),
        "bar_footprints": lambda: bar_footprints(
            tr.ticks, tr.amounts, ci_d, tr.sides, ohlcv_d, tick_size=tr.tick_size,
            price_tick_size=0.1, imbalance_factor=3.0),
        "bar_trade_size_features": lambda: bar_trade_size_features(
            tr.units, tr.amounts, ci_d, ohlcv_d["median_trade_size"], theta_mult=5.0,
            amount_scale=tr.amount_scale),
        "cusum_filter": lambda: cusum_filter(close, [0.0005]),
        "triple_barrier": lambda: triple_barrier(bar_ts, close, events, targets, (1, 1), 600.0),
        "average_uniqueness": lambda: average_uniqueness(bar_ts, events, labels[1]),
        "return_attribution": lambda: return_attribution(events, labels[1], close, conc),
    }


# reads on the CPU: the time index without its first and last timestamps
# reads both; the dollar index its total and its count; the footprints their
# levels; CUSUM the closes and the copy of its events back (on the card, one:
# kernel Z's event count); the labels one a
# round (every path here ends within the first round of 256 bars, and a
# second finds none left); the attribution its sum; the trade sizes'
# segment_reduce checks its lengths with two. The products' check of ci
# reads on the card only.
ENTRY_READS = {"time_bar_indexer": 2, "dollar_bar_indexer_q": 2, "bar_products_final": 0,
               "bar_footprints": 1, "bar_trade_size_features": 2, "cusum_filter": 2,
               "triple_barrier": 2, "average_uniqueness": 0, "return_attribution": 1}


@pytest.mark.parametrize("entry", sorted(ENTRY_READS))
def test_entry_opens_its_span_once_a_call(registry, pass_inputs, entry):
    for k in range(1, 3):
        pass_inputs[entry]()
        rep = trace.report()
        tops = {n for n, v in rep.items() if v["top"]}
        assert tops == {entry}
        assert (rep[entry]["calls"], rep[entry]["top"]) == (k, k)
        assert rep[entry]["reads"] == k * ENTRY_READS[entry]
    if entry == "bar_footprints":
        assert (rep["check_grid_fits"]["calls"], rep["check_grid_fits"]["top"]) == (2, 0)
        assert rep["check_grid_fits"]["host_ms"] > 0
    if entry == "cusum_filter":
        assert rep["cusum_filter.loop"]["calls"] == 2
        assert rep[entry]["host_ms"] > rep["cusum_filter.loop"]["host_ms"] > 0


# --- the event indexers (tick, volume, CUSUM, imbalance, run) ------------------


@pytest.fixture(scope="module")
def event_calls():
    """Each event indexer as the bar kits call it, on the CPU trades; on CPU
    tensors the scans are their plain versions."""
    tr = _trades()
    sigma = torch.full((N_TRADES,), 2e-4, dtype=torch.float64)
    sigma[:3] = float("nan")
    prices = tr.ticks.to(torch.float64) / (1.0 / tr.tick_size)
    thr = 40 * float(tr.amounts.double().mean())
    return {
        "tick_bar_indexer": lambda: tick_bar_indexer(tr.timestamps, 100),
        "volume_bar_indexer_q": lambda: volume_bar_indexer_q(
            tr.timestamps, tr.units, thr, tr.amount_scale),
        "cusum_bar_indexer": lambda: cusum_bar_indexer(tr.timestamps, prices, sigma, 1e-9,
                                                       3.0),
        "imbalance_bar_indexer": lambda: imbalance_bar_indexer(tr.timestamps, tr.sides,
                                                               threshold=12.0),
        "run_bar_indexer": lambda: run_bar_indexer(
            tr.timestamps, tr.sides, expected_ticks_init=40.0, expected_rate_init=0.5,
            alpha_ticks=0.05, alpha_rate=0.05),
    }


# reads on the CPU (the scans' plain versions read no card): the volume index
# its total, the CUSUM index its first valid sigma; on the card each also
# reads kernel E's count (tests/test_torch_cuda.py)
EVENT_READS = {"tick_bar_indexer": 0, "volume_bar_indexer_q": 1, "cusum_bar_indexer": 1,
               "imbalance_bar_indexer": 0, "run_bar_indexer": 0}


@pytest.mark.parametrize("entry", sorted(EVENT_READS))
def test_event_indexer_opens_its_span_once_a_call(registry, event_calls, entry):
    first = event_calls[entry]()
    assert first[1].shape[0] > 3
    rep = trace.report()
    assert {n for n, v in rep.items() if v["top"]} == {entry}
    assert (rep[entry]["calls"], rep[entry]["top"]) == (1, 1)
    assert rep[entry]["reads"] == EVENT_READS[entry]
    event_calls[entry]()
    rep = trace.report()
    assert (rep[entry]["calls"], rep[entry]["top"], rep[entry]["timed"]) == (2, 2, 1)
    assert rep[entry]["reads"] == 2 * EVENT_READS[entry]
    assert trace.counter("event_scan.regrow") == 0


@pytest.mark.parametrize("entry", ["cusum_bar_indexer", "imbalance_bar_indexer",
                                   "run_bar_indexer"])
def test_a_full_close_buffer_counts_a_regrowth(registry, event_calls, entry, monkeypatch):
    """A close buffer of 4 fills; each scan again counts once against the
    indexer's span, and the closes are those of a buffer that never fills."""
    from finmlkit_tpu_torch.bar import indexers
    want = event_calls[entry]()[1]
    trace.reset()
    monkeypatch.setattr(indexers, "_FIRST_BUFFER", 4)
    got = event_calls[entry]()[1]
    assert torch.equal(got, want)
    bars = want.shape[0] - 1
    grown = sum(4 ** k <= bars for k in range(1, 12))   # buffers of 4, 16, 64, ... that fill
    assert grown >= 1
    assert trace.counter("event_scan.regrow") == grown
    assert trace.report()[entry]["counts"] == {"event_scan.regrow": grown}


def test_entries_keep_their_names_and_signatures():
    assert dollar_bar_indexer_q.__name__ == "dollar_bar_indexer_q"
    assert "threshold" in inspect.signature(dollar_bar_indexer_q).parameters
    assert "Integer-exact" in dollar_bar_indexer_q.__doc__


def test_tracing_off_opens_no_range(registry, pass_inputs):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass_inputs["dollar_bar_indexer_q"]()
    names = [e.name for e in prof.events()]
    assert any(n.startswith("aten::") for n in names)
    assert not [n for n in names if n.startswith("fmkt.")]
    assert trace.report()["dollar_bar_indexer_q"]["calls"] == 1


def test_tracing_on_encloses_the_entry_ops(registry, pass_inputs):
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass_inputs["dollar_bar_indexer_q"]()
    events = list(prof.events())
    ranges = [e for e in events if e.name == "fmkt.dollar_bar_indexer_q"]
    assert len(ranges) == 1
    r = ranges[0].time_range
    inside = [e for e in events if e.name.startswith("aten::")
              and r.start <= e.time_range.start and e.time_range.end <= r.end]
    assert {"aten::searchsorted", "aten::cummax"} <= {e.name for e in inside}

    def under(e):
        while e is not None:
            if e.name == "fmkt.dollar_bar_indexer_q":
                return True
            e = e.cpu_parent
        return False
    assert all(under(e) for e in inside)


# --- the launch keys -----------------------------------------------------------


def test_no_counter_global_is_left():
    left = []
    for p in sorted(PACKAGE.rglob("*.py")):
        for k, line in enumerate(p.read_text().splitlines(), 1):
            if re.search(r"\b\w*LAUNCHES\b|RING_SECONDS|build_seconds", line):
                left.append(f"{p.relative_to(PACKAGE)}:{k}: {line.strip()}")
    assert left == []


def test_mode_and_route_names():
    from finmlkit_tpu_torch.ops import event_scan, float_walk
    assert event_scan.MODE_NAMES[event_scan._CUSUM] == "cusum"
    assert event_scan.MODE_NAMES[event_scan._IMBALANCE_MAP] == "imbalance_map"
    assert event_scan.MODE_NAMES[event_scan._RUN_COUNT] == "run_count"
    assert float_walk.ROUTE_NAMES[float_walk.UNITS] == "units"
    assert len(event_scan.MODE_NAMES) == 6 and len(float_walk.ROUTE_NAMES) == 3
