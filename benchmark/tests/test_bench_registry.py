"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries alone: the harness finds them by name, with no file of the
benchmark edited."""
import json
import shutil
import time

import harness

KINDS = ("configs", "workloads", "limits", "steps", "reference", "metrics", "bytecounts")


def test_new_files_found_by_name(tmp_path):
    bench = tmp_path / "benchmark"
    for kind in KINDS:
        shutil.copytree(harness.BENCH_DIR / kind, bench / kind)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    spec = harness.load_json(harness.SPEC)

    cfg = json.loads((bench / "configs" / "btcusdt-month-time1m.json").read_text())
    cfg["name"] = "btcusdt-month-time5m"
    cfg["settings"]["time_index"]["interval_s"] = 300.0
    (bench / "configs" / "btcusdt-month-time5m.json").write_text(json.dumps(cfg))
    (bench / "workloads" / "bars-only.json").write_text(json.dumps({
        "name": "bars-only", "loop": "closed", "clients": 1, "warm_passes": 1,
        "profile_seconds": 0.2,
        "steps": [{"step": "time_index", "stage": "time_index"},
                  {"step": "bar_products", "stage": "products", "params": {}}]}))
    (bench / "limits" / "time5m.bars-only.json").write_text(json.dumps(
        {"limits": {"mismatches": 0, "ohlcv_f64": 1e-9, "ohlcv_f32": 1e-5,
                    "directional_f32": 1e-5}}))
    (bench / "metrics" / "bars_per_pass.py").write_text(
        "def read(run):\n    return run.outputs['ci'].shape[0] - 1\n")
    spec["configs"].append({"name": "btcusdt-month-time5m", "source": "test",
                            "file": "benchmark/configs/btcusdt-month-time5m.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "time5m.bars-only", "config": "btcusdt-month-time5m",
                              "traffic": "bars-only", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "bars_per_pass", "unit": "bars", "better": "higher",
                              "source": "program_counter", "layer": "time index",
                              "moves": "trades_per_s", "workloads": ["time5m.bars-only"]})

    res = harness.run_cell("time5m.bars-only", 5, 0.1, True, "cpu", time.perf_counter(),
                           spec=spec, bench_dir=bench, n_trades=100_000,
                           log=lambda line: None)
    assert res["correct"] is True
    n_bars = res["metrics"]["bars_per_pass"]["value"]
    assert 20 <= n_bars <= 28           # about 117 minutes of trades, 5 minutes a bar
    assert "labels_ms" not in res["metrics"]
    assert {p: p.read_bytes() for p in before} == before
