"""The port's Binance CLI (``finmlkit_tpu_torch/cli/binance2h5.py``) against the
JAX package's (``finmlkit_tpu/cli/binance2h5.py``), offline, on local ZIPs.

Header and headerless 6-field (futures) ZIPs load to the JAX loader's columns
and preprocess to its ``_process_task``'s, exact, also at 3,000,000 rows,
where the port's streaming parse stays within its columns' size and a few
blocks of memory. A store written by
``process_all`` loads in JAX equal to the port's load. The writer's first
error is raised after the queue drains, without a deadlock, and after it no
month is written. ``orchestrate_symbol`` and ``main`` run with the ZIP present
and ``download`` patched to fail if called. Binance's spot files have seven
fields and no header: the port reads them by that count, while the JAX loader
names six and pandas shifts every column by one (ROADMAP.md, Queue 3, R17),
which ``test_r17_spot_zip`` pins.
"""
import hashlib
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pandas as pd
import pytest

from finmlkit_tpu.cli import binance2h5 as jcli
from finmlkit_tpu.data import store as jstore
from finmlkit_tpu_torch.cli import binance2h5 as cli
from finmlkit_tpu_torch.data import klines, store
from finmlkit_tpu_torch.testing import assert_exact

SPOT = ("id", "price", "qty", "quote_qty", "time", "is_buyer_maker", "is_best_match")


def _rows(n=3000, seed=7, t0_ms=1_700_000_000_000):
    r = np.random.default_rng(seed)
    ts = t0_ms + np.cumsum(r.integers(1, 400, n)).astype(np.int64)
    price = np.round(40_000 * np.exp(np.cumsum(r.normal(0, 5e-5, n))), 1)
    qty = np.round(r.lognormal(-3, 1.3, n), 5)
    ts[n // 2:] += 90_000       # an id gap over 90 s: a discontinuity
    ids = np.arange(n, dtype=np.int64) + 12_345
    ids[n // 2:] += 3
    return {"id": ids, "price": price, "qty": qty, "quote_qty": np.round(price * qty, 2),
            "time": ts, "is_buyer_maker": r.random(n) < 0.5,
            "is_best_match": np.ones(n, bool)}


def _zip(path, cols, names, header=None, bools=("True", "False")):
    def cell(v):
        if isinstance(v, (bool, np.bool_)):
            return bools[0] if v else bools[1]
        return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)

    lines = [",".join(cell(cols[c][i]) for c in names) for i in range(len(cols["id"]))]
    if header is not None:
        lines.insert(0, ",".join(header))
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(os.path.basename(path).replace(".zip", ".csv"), "\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def zips(tmp_path_factory):
    d = tmp_path_factory.mktemp("zips")
    cols = _rows()
    fut = SPOT[:6]
    return cols, {
        "futures": _zip(d / "BTCUSDT-trades-2023-11.zip", cols, fut, bools=("true", "false")),
        "header": _zip(d / "hdr-trades-2023-11.zip", cols, fut, header=fut),
        "header_names": _zip(d / "names-trades-2023-11.zip", cols, fut,
                             header=["id", "Price", "amount", "quote qty", "timestamp",
                                     "is_buyer_maker"]),
        "spot": _zip(d / "SPOT-trades-2023-11.zip", cols, SPOT),
    }


def _hold_frame(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert_exact(got[c], want[c].values, c)


@pytest.mark.parametrize("case", ["futures", "header", "header_names"])
def test_load_csv_matches_jax(zips, case):
    cols, paths = zips
    got = cli.load_csv_from_zip(paths[case])
    _hold_frame(got, jcli.load_csv_from_zip(paths[case]))
    for c in ("id", "price", "qty", "time", "is_buyer_maker"):
        assert_exact(got[c], cols[c], c)


BIG_ROWS = 3_000_000
# the parse's peak resident memory above the process's before it, against its
# columns' bytes: columns allocated 5% beyond the rows predicted, and a few
# 4 MiB blocks of text and rows beside them (Linux: read from /proc/self/status;
# ru_maxrss would carry the parent's peak over the exec)
PEAK_FACTOR, PEAK_SLACK = 1.1, 96 << 20
_PEAK = """
import hashlib, json, sys
from finmlkit_tpu_torch.cli import binance2h5

def kib(key):
    with open("/proc/self/status") as f:
        return next(int(ln.split()[1]) for ln in f if ln.startswith(key + ":"))

before = kib("VmRSS")
cols = binance2h5.load_csv_from_zip(sys.argv[1])
print(json.dumps({"peak": (kib("VmHWM") - before) * 1024,
                  "bytes": sum(c.nbytes for c in cols.values()),
                  "digest": {k: [str(c.dtype), len(c), hashlib.sha256(c.tobytes()).hexdigest()]
                             for k, c in cols.items()}}))
"""


def test_load_csv_at_millions_of_rows(tmp_path):
    """A futures ZIP of ``BIG_ROWS`` rows (3,000 distinct rows repeated) parses,
    in a process of its own, to the JAX loader's columns, exact, with a peak
    of at most ``PEAK_FACTOR`` times its columns' bytes plus ``PEAK_SLACK``
    above what the process held before (at 3M rows the columns are 123 MB; a
    parse that makes a Python object a field takes over 2 GB)."""
    cols = _rows()
    small = _zip(tmp_path / "small.zip", cols, SPOT[:6], bools=("true", "false"))
    with zipfile.ZipFile(small) as z:
        text = z.read(z.namelist()[0])
    path = str(tmp_path / "BTCUSDT-trades-2023-11.zip")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as z:
        z.writestr("BTCUSDT-trades-2023-11.csv", text * (BIG_ROWS // len(cols["id"])))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _PEAK, path], capture_output=True,
                         text=True, cwd=root, check=True)
    got = json.loads(run.stdout.strip().splitlines()[-1])
    want = jcli.load_csv_from_zip(path)
    assert list(got["digest"]) == list(want.columns)
    for c in want.columns:
        v = want[c].values
        assert got["digest"][c] == [str(v.dtype), BIG_ROWS,
                                    hashlib.sha256(v.tobytes()).hexdigest()], c
    assert got["bytes"] == sum(want[c].values.nbytes for c in want.columns)
    assert got["peak"] <= PEAK_FACTOR * got["bytes"] + PEAK_SLACK, got


@pytest.mark.parametrize("case", ["futures", "header"])
def test_process_task_matches_jax(zips, case):
    _, paths = zips
    month, cols, ok, missing, disc = cli._process_task((paths[case], "2023-11"))
    jm, jcols, jok, jmissing, jdisc = jcli._process_task((paths[case], "2023-11"))
    assert (month, ok, missing) == (jm, jok, jmissing) == ("2023-11", False, missing)
    assert missing > 0 and len(disc) == len(jdisc)
    assert sorted(cols) == sorted(jcols) == ["amount", "price", "side", "timestamp"]
    for c in jcols:
        assert_exact(cols[c], jcols[c], c)
    assert cols["timestamp"][0] > 1e18


def test_r17_spot_zip(zips):
    """A headerless spot file of seven fields: the port names them by the
    spot layout; the JAX loader names six, so pandas makes the first field
    the index and shifts the rest (R17): its ``id`` holds the prices, its
    ``time`` the ``is_buyer_maker`` flags."""
    cols, paths = zips
    got = cli.load_csv_from_zip(paths["spot"])
    assert tuple(got) == SPOT
    for c in SPOT:
        assert_exact(got[c], cols[c], c)
    month, pc, *_ = cli._process_task((paths["spot"], "2023-11"))
    _, fc, *_ = cli._process_task((paths["futures"], "2023-11"))
    for c in fc:
        assert_exact(pc[c], fc[c], c)
    shifted = jcli.load_csv_from_zip(paths["spot"])   # R17, not copied
    assert list(shifted.columns) == list(jcli._COLS)
    np.testing.assert_array_equal(shifted["id"].values, cols["price"])
    np.testing.assert_array_equal(shifted["time"].values.astype(bool), cols["is_buyer_maker"])


@pytest.mark.parametrize("block", [1 << 11, 1 << 22])
def test_types_widen_as_pandas_infers(tmp_path, monkeypatch, block):
    """Column types read from the first rows widen where later rows need it
    (ints then floats: float64; words that are not True or False: str), to
    the types and values the JAX loader's pandas gives; with small blocks the
    widening comes in a later block, and the file is read again."""
    lines = ["id,price,qty,quote_qty,time,is_buyer_maker,note"]
    for i in range(400):
        qty = str(i % 7 + 1) if i < 200 else str((i % 7 + 1) / 8)
        note = ("True" if i % 2 else "false") if i < 300 else "x"
        lines.append(f"{i},{100 + i / 10},{qty},{i * 2.5},{1_700_000_000_000 + i},"
                     f"{'True' if i % 3 else 'False'},{note}")
    path = str(tmp_path / "wide.zip")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("wide.csv", "\n".join(lines) + "\n")
    monkeypatch.setattr(cli, "_BLOCK", block)
    monkeypatch.setattr(cli, "_SAMPLE", 512)
    got = cli.load_csv_from_zip(path)
    want = jcli.load_csv_from_zip(path)
    note = got.pop("note")
    _hold_frame(got, want.drop(columns="note"))
    assert note.dtype == object and list(note) == list(want["note"])
    with zipfile.ZipFile(path, "w") as z:        # a row of another width
        z.writestr("wide.csv", "\n".join(lines[:300] + ["1,2,3"] + lines[300:]) + "\n")
    with pytest.raises(ValueError, match="columns"):
        cli.load_csv_from_zip(path)


@pytest.mark.parametrize("fields", [5, 8])
def test_unknown_field_counts_raise(tmp_path, fields):
    cols = _rows(n=10)
    cols.update(extra=np.zeros(10, np.int64))
    names = list(SPOT[:fields]) if fields < 7 else list(SPOT) + ["extra"]
    path = _zip(tmp_path / "odd.zip", cols, names)
    with pytest.raises(ValueError, match="7 \\(spot\\) or 6 \\(futures\\)"):
        cli.load_csv_from_zip(path)


def test_process_all_store_loads_in_jax(zips, tmp_path):
    _, paths = zips
    h5 = str(tmp_path / "BTCUSDT.h5")
    cli.process_all([(paths["futures"], "2023-11"), (paths["spot"], "2023-12")], h5,
                    workers=1)
    for key in ("2023-11", "2023-12"):
        got = store.load_trades_h5(h5, key=key)
        want = jstore.load_trades_h5(h5, key=key)
        for c in got.data:
            assert_exact(got.data[c], want.data[c].values, c)
    jm = jstore.H5Inspector(h5).get_metadata("/trades/2023-11")
    assert jm == store.H5Inspector(h5).get_metadata("/trades/2023-11")
    assert bool(jm["data_integrity_ok"]) is False


def test_process_all_in_a_pool_matches_one_process(zips, tmp_path):
    _, paths = zips
    months = [(paths["futures"], "2023-11"), (paths["header"], "2023-12")]
    one, two = str(tmp_path / "one.h5"), str(tmp_path / "two.h5")
    cli.process_all(months, one, workers=1)
    cli.process_all(months, two, workers=2)
    a, b = store.load_trades_h5(one), store.load_trades_h5(two)
    for c in a.data:
        assert_exact(b.data[c], a.data[c], c)


def test_writer_error_reraised_without_deadlock(zips, tmp_path, monkeypatch):
    _, paths = zips

    def boom(*a, **kw):
        raise OSError("disk full (synthetic)")

    monkeypatch.setattr(store, "save_trades_h5", boom)
    with pytest.raises(OSError, match="disk full"):
        cli.process_all([(paths["futures"], "2023-11")] * 4, str(tmp_path / "o.h5"),
                        workers=1)


def test_fail_fast_drains_without_writing(zips, tmp_path, monkeypatch):
    _, paths = zips
    calls = {"n": 0}

    def flaky(trades, path, month_key=None, **kw):
        calls["n"] += 1
        raise OSError("write fails")

    monkeypatch.setattr(store, "save_trades_h5", flaky)
    h5 = str(tmp_path / "out.h5")
    with pytest.raises(OSError):
        cli.process_all([(paths["futures"], "2023-11")] * 3, h5, workers=1)
    assert calls["n"] == 1
    assert not os.path.exists(h5)


@pytest.mark.parametrize("start, end", [("2023-11", "2024-02"), ("2024-01", "2024-01"),
                                        ("1999-12", "2001-01"), ("2024-03", "2024-02")])
def test_month_range_matches_jax(start, end):
    assert list(cli.month_range(start, end)) == list(jcli.month_range(start, end))


def test_checksum(zips, tmp_path):
    _, paths = zips
    with open(paths["futures"], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    cs = tmp_path / "x.CHECKSUM"
    cs.write_text(f"{digest}  file.zip\n")
    assert cli.verify_checksum(paths["futures"], str(cs))
    cs.write_text("deadbeef  file.zip\n")
    assert not cli.verify_checksum(paths["futures"], str(cs))


def _no_download(*a, **kw):
    raise AssertionError("download called with the ZIP present")


@pytest.mark.parametrize("entry", ["orchestrate_symbol", "main"])
def test_orchestrate_offline(zips, tmp_path, monkeypatch, entry):
    cols, _ = zips
    out = tmp_path / "data"
    out.mkdir()
    zp = _zip(out / "ETHUSDT-trades-2023-11.zip", cols, SPOT)
    monkeypatch.setattr(cli, "download", _no_download)
    if entry == "main":
        cli.main(["--tickers", "ETHUSDT", "--start", "2023-11", "--end", "2023-11",
                  "--output-dir", str(out), "--workers", "1", "--device", "cpu"])
    else:
        cli.orchestrate_symbol("ETHUSDT", ["2023-11"], "spot", str(out), 1, False,
                               device="cpu")
    assert not os.path.exists(zp)
    h5 = str(out / "ETHUSDT.h5")
    assert_exact(store.load_trades_h5(h5).data["price"],
                 jstore.load_trades_h5(h5).data["price"].values)
    bars = klines.TimeBarReader(h5, device="cpu").read(timeframe="1min")
    assert int(bars["trades"].sum()) > 0.99 * len(cols["id"])


def test_orchestrate_keeps_zips(zips, tmp_path, monkeypatch):
    cols, _ = zips
    zp = _zip(tmp_path / "XRPUSDT-trades-2023-11.zip", cols, SPOT[:6])
    monkeypatch.setattr(cli, "download", _no_download)
    cli.orchestrate_symbol("XRPUSDT", ["2023-11"], "um", str(tmp_path), 1, True,
                           device="cpu")
    assert os.path.exists(zp)
