"""No process of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the program. Each check runs in a fresh
interpreter and compares whole top-level module names: the port's name
begins with the JAX package's."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import harness

ROOT = harness.BENCH_DIR.parent
RUN_CELL = """
import json, sys, time
sys.path[:0] = [{bench!r}, {root!r}]
import harness
res = harness.run_cell({cell!r}, 9, 0.1, False, "cpu", time.perf_counter(),
                       n_trades=50_000, log=lambda line: None)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"correct": res["correct"], "tops": tops}}))
"""
REFERENCE_ONLY = """
import json, sys
sys.path[:0] = [{bench!r}]
import harness, month
cell = harness.Cell({cell!r}, harness.load_json(harness.SPEC))
m = month.synthesize(cell.config["assumed"]["month"], 4, "cpu", 50_000)
harness.reference_outputs(cell, m, month.thresholds(m, cell.config["settings"]), "cpu")
print(json.dumps({{"tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""

PLANTED = """
import json, sys, time
sys.path[:0] = [{stubs!r}, {bench!r}, {root!r}]
import harness
spec = harness.load_json(harness.SPEC)
spec["end_to_end"].append({{"name": "planted", "unit": "ms", "better": "lower", "bound": 0.25,
                           "source": "host_clock", "workloads": ["time1m.labels"]}})
try:
    harness.run_cell("time1m.labels", 9, 0.1, False, "cpu", time.perf_counter(), spec=spec,
                     bench_dir={planted!r}, n_trades=50_000, log=lambda line: None)
    print(json.dumps({{"raised": None}}))
except harness.ForbiddenImport as e:
    print(json.dumps({{"raised": str(e)}}))
"""


def _tops(code):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_in_a_run():
    res = _tops(RUN_CELL.format(bench=str(harness.BENCH_DIR), root=str(ROOT),
                                cell="infobars.dollar-footprint"))
    assert res["correct"] is True
    assert "finmlkit_tpu_torch" in res["tops"]
    assert not set(res["tops"]) & set(harness.FORBIDDEN)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules


def test_reference_imports_nothing_of_the_program():
    for cell in ("time1m.labels", "infobars.dollar-footprint"):
        res = _tops(REFERENCE_ONLY.format(bench=str(harness.BENCH_DIR), cell=cell))
        assert not {"finmlkit_tpu_torch", *harness.FORBIDDEN} & set(res["tops"])


@pytest.mark.parametrize("kind", ("metrics", "reference"))
def test_import_after_the_window_gives_no_result(tmp_path, kind):
    """A metric reader or a reference step that imports the JAX package (a
    stub of that name here) once the window has closed stops the run."""
    stubs = tmp_path / "stubs" / "finmlkit_tpu"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    planted = tmp_path / "benchmark"
    for sub in ("configs", "workloads", "limits", "steps", "reference", "metrics", "bytecounts"):
        shutil.copytree(harness.BENCH_DIR / sub, planted / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    if kind == "metrics":
        (planted / "metrics" / "planted.py").write_text(
            "import finmlkit_tpu  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    else:
        (planted / "metrics" / "planted.py").write_text("def read(run):\n    return 1.0\n")
        ref = planted / "reference" / "time_index.py"
        ref.write_text("import finmlkit_tpu  # noqa: F401\n" + ref.read_text())
    res = _tops(PLANTED.format(stubs=str(stubs.parent), bench=str(harness.BENCH_DIR),
                               root=str(ROOT), planted=str(planted)))
    assert res["raised"] and "finmlkit_tpu" in res["raised"]
