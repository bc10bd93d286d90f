"""``run.py`` from the command line: no result without a card, or in a
directory that holds only ``BENCHMARK.json`` and the benchmark; and, on the
card, each cell's short run correct, with every metric of its mode."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness

ROOT = harness.BENCH_DIR.parent
CELLS = ("time1m.labels", "infobars.dollar-footprint")


def _run(cwd, *args, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, env=env, timeout=900)


def _json_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("{")]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
               "--trace", "0", env=env)
    assert out.returncode != 0 and not _json_lines(out.stdout)


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", CELLS[1], "--seed", "1", "--seconds", "1",
               "--trace", "0")
    assert out.returncode != 0 and not _json_lines(out.stdout)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_cell_on_the_card(card, cell, trace):
    out = _run(ROOT, "--workload", cell, "--seed", str(2**31 + 5), "--seconds", "2",
               "--trace", str(trace))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    spec = harness.load_json(harness.SPEC)
    assert set(res["metrics"]) == {m["name"] for m in harness.Cell(cell, spec).metrics[trace]}
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
