"""Binance monthly trades to the HDF5 store and its 1-second klines, without
pandas.

Counterpart of ``finmlkit_tpu/cli/binance2h5.py``: download a month's trade
ZIP from data.binance.vision (spot, um or cm) where it is missing, check its
``.CHECKSUM``, preprocess the months in a pool of processes (the port's
``TradesData``) that feeds one writer thread through a bounded queue, then
build the 1-second klines on the card (``data/klines.py AddTimeBarH5``).

The CSV has no header in Binance's files; a file with one is read by its
names. Headerless rows are read by their field count: seven fields are the
spot layout (``id, price, qty, quote_qty, time, is_buyer_maker,
is_best_match``), six the futures layout (without ``is_best_match``), and any
other count raises. The JAX loader names six columns whatever the count, so
on a spot file pandas shifts every column by one (ROADMAP.md, Queue 3, R17);
this one does not.

Usage:
    binance2h5-torch --tickers BTCUSDT --start 2024-01 --end 2024-03 \\
        --market spot --output-dir ./data --workers 4
    python -m finmlkit_tpu_torch.cli.binance2h5 ...
"""
import argparse
import hashlib
import io
import multiprocessing
import os
import queue
import threading
import types
import urllib.error
import urllib.request
import warnings
import zipfile

import numpy as np

from ..bar.data_model import TradesData
from ..data import store
from ..data.klines import AddTimeBarH5
from ..utils.log import get_logger

__all__ = ["month_range", "download", "verify_checksum", "load_csv_from_zip",
           "process_all", "orchestrate_symbol", "main"]

logger = get_logger(__name__)

_BASE = {
    "spot": "https://data.binance.vision/data/spot/monthly/trades",
    "um": "https://data.binance.vision/data/futures/um/monthly/trades",
    "cm": "https://data.binance.vision/data/futures/cm/monthly/trades",
}

# the headerless layouts, by field count
_FUTURES_COLS = ("id", "price", "qty", "quote_qty", "time", "is_buyer_maker")
_LAYOUTS = {6: _FUTURES_COLS, 7: _FUTURES_COLS + ("is_best_match",)}


def month_range(start: str, end: str):
    """The months ``"YYYY-MM"`` from ``start`` to ``end``, both included."""
    cur, stop = np.datetime64(start, "M"), np.datetime64(end, "M")
    while cur <= stop:
        yield str(cur)
        cur += 1


def download(url: str, dest: str, retries: int = 2) -> str:
    for attempt in range(retries + 1):
        try:
            logger.info(f"Downloading {url}")
            urllib.request.urlretrieve(url, dest)
            return dest
        except Exception as e:  # noqa: BLE001 - retried, the last one re-raised
            if attempt == retries:
                raise
            logger.warning(f"Download failed ({e}); retrying...")
    return dest


def verify_checksum(zip_path: str, checksum_path: str) -> bool:
    """sha256 of the ZIP against its ``.CHECKSUM`` file."""
    with open(checksum_path) as f:
        expected = f.read().split()[0].strip()
    h = hashlib.sha256()
    with open(zip_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == expected


# How a column is read: int64, widened to float64 where a field is not an int,
# else bool (pandas' words), else str (object). A column of ints and bools, or
# of anything and a word, is read as str.
_CHAIN = {None: ("i8", "f8", "b", "O"), "i8": ("i8", "f8", "b", "O"), "f8": ("f8", "O"),
          "b": ("b", "O"), "O": ("O",)}
_TRUE, _FALSE = (b"True", b"TRUE", b"true"), (b"False", b"FALSE", b"false")
_BLOCK = 1 << 22        # bytes of CSV parsed at a time
_SAMPLE = 1 << 16       # bytes of the first block the column types are first read from


def _line_blocks(f):
    """The byte stream ``f`` in blocks of whole lines, about ``_BLOCK`` each."""
    rest = b""
    while True:
        buf = f.read(_BLOCK)
        if not buf:
            break
        buf = rest + buf
        cut = buf.rfind(b"\n") + 1
        rest = buf[cut:]
        if cut:
            yield buf[:cut]
    if rest.strip():
        yield rest


def _parse(buf: bytes, kinds, usecols=None):
    """The rows of the CSV block ``buf`` as one numpy column per kind, read by
    numpy's C parser (no Python object per field but in str columns). Raises
    ValueError where a field does not read as its kind or a row has another
    field count."""
    dtype = np.dtype([(f"f{i}", "S6" if k == "b" else k) for i, k in enumerate(kinds)])
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)   # "2.5" read as an int
        try:
            rows = np.loadtxt(io.BytesIO(buf), delimiter=",", dtype=dtype, usecols=usecols,
                              comments=None, ndmin=1, encoding="utf-8")
        except DeprecationWarning as e:
            raise ValueError(str(e)) from None
    cols = []
    for i, k in enumerate(kinds):
        col = rows[f"f{i}"]
        if k == "b":
            true = np.logical_or.reduce([col == w for w in _TRUE])
            if not (true | np.logical_or.reduce([col == w for w in _FALSE])).all():
                raise ValueError(f"column {i} holds a field that is neither True nor False")
            col = true
        cols.append(col)
    return cols


def _widen(buf: bytes, kinds):
    """``kinds`` widened so that every field of the block ``buf`` reads: each
    column tried along its chain, alone (a kind of None: not known yet)."""
    out = []
    for i, kind in enumerate(kinds):
        for k in _CHAIN[kind]:
            try:
                _parse(buf, [k], usecols=[i])
            except ValueError:
                continue
            out.append(k if kind in (None, k) else "f8" if {kind, k} == {"i8", "f8"} else "O")
            break
    return out


def _width_fault(path: str, buf: bytes, width: int):
    """Raise the fault of a block whose fields read as no type: its rows read
    as ``width`` str columns, which fails where a row has another width."""
    try:
        _parse(buf, ["O"] * width)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    raise ValueError(f"{path}: a field reads as no column type")


def _read(z: zipfile.ZipFile, name: str, skip: int, kinds):
    """The file ``name`` of ``z`` past its first ``skip`` bytes, parsed a
    block at a time as ``kinds`` into columns sized for the rows that the
    bytes read so far predict: ``(columns, rows, None)``, or ``(None, 0,
    wider)`` at the first block that needs wider kinds."""
    size = z.getinfo(name).file_size - skip
    cols, n, read = None, 0, 0
    with z.open(name) as f:
        f.read(skip)
        for buf in _line_blocks(f):
            if not buf.strip():
                continue
            try:
                part = _parse(buf, kinds)
            except ValueError:
                wider = _widen(buf, kinds)
                if len(wider) < len(kinds) or wider == kinds:   # not a matter of types
                    _width_fault(z.filename, buf, len(kinds))
                return None, 0, wider
            m = len(part[0])
            read += len(buf)
            if cols is None or n + m > len(cols[0]):
                # room left untouched (and so not resident) until rows fill it
                cap = max(int((n + m) * size / read * 1.05) + 16, n + m)
                grown = [np.empty(cap, p.dtype) for p in part]
                for g, c in zip(grown, cols or []):
                    g[:n] = c[:n]
                cols = grown
            for c, p in zip(cols, part):
                c[n:n + m] = p
            n += m
    return cols, n, None


def load_csv_from_zip(zip_path: str) -> dict:
    """The first file of a monthly trades ZIP as a dict of numpy columns,
    named by its header or by its field count (see the module docstring),
    names normalized (lower case, ``_`` for spaces; ``amount`` read as
    ``qty``, ``timestamp`` as ``time``). Each column is typed as pandas
    types it: int64, float64, bool or str.

    The file is decompressed and parsed a block of ``_BLOCK`` bytes at a
    time, so a month of tens of millions of trades takes about its columns'
    size (42 bytes a spot trade) and a few blocks beside them. The column
    types are read from the first ``_SAMPLE`` bytes; where a later block
    needs a wider type, the file is read again with it."""
    with zipfile.ZipFile(zip_path) as z:
        name = z.namelist()[0]
        with z.open(name) as f:
            first = next(_line_blocks(f), b"")
        line = first.split(b"\n", 1)[0]
        has_header = line.startswith(b"id,") or b"price" in line
        if has_header:
            names = [c.strip() for c in line.decode().split(",")]
            first = first[len(line) + 1:]
        else:
            width = next((ln.count(b",") + 1 for ln in first.splitlines() if ln.strip()), 0)
            if width not in _LAYOUTS:
                raise ValueError(f"{zip_path}: {width} fields a row and no header; "
                                 f"Binance's trade files have 7 (spot) or 6 (futures)")
            names = list(_LAYOUTS[width])
        sample = first[:first.rfind(b"\n", 0, _SAMPLE) + 1] or first
        kinds = _widen(sample, [None] * len(names)) if sample.strip() else ["i8"] * len(names)
        if len(kinds) < len(names):
            _width_fault(zip_path, sample, len(names))
        del first, sample
        wider = kinds
        while wider is not None:
            kinds = wider
            cols, n, wider = _read(z, name, len(line) + 1 if has_header else 0, kinds)
    if cols is None:
        cols = [np.empty(0, np.int64) for _ in names]
    names = [c.strip().lower().replace(" ", "_") for c in names]
    for old, new in (("amount", "qty"), ("timestamp", "time")):
        if new not in names and old in names:
            names[names.index(old)] = new
    return {name: c[:n] for name, c in zip(names, cols)}


def _process_task(args):
    """A worker: one month's ZIP -> ``(month, columns, data_ok, missing_pct,
    discontinuities)`` of the preprocessed :class:`TradesData`."""
    zip_path, month = args
    return _preprocess(load_csv_from_zip(zip_path), month)


def _preprocess(c: dict, month: str):
    """:func:`_process_task` on the columns ``c`` of a loaded ZIP."""
    trades = TradesData(
        c["time"].astype(np.int64), c["price"].astype(np.float64),
        c["qty"].astype(np.float32), c["id"].astype(np.int64),
        is_buyer_maker=c["is_buyer_maker"].astype(bool), preprocess=True, name=month)
    d = trades.data
    return (month, {k: d[k] for k in ("timestamp", "price", "amount", "side")},
            trades.data_ok, trades.missing_pct, trades.discontinuities)


def _writer(h5_path: str, q: "queue.Queue", errors: list):
    """The one writer thread: writes each month it takes from ``q`` into the
    store until it takes None. After a failed write it records the error and
    drains the queue without writing, so the producer never blocks on the
    bounded queue; :func:`process_all` re-raises after the join."""
    while True:
        item = q.get()
        if item is None:
            break
        if errors:
            continue
        month, cols, data_ok, missing_pct, disc = item
        trades = types.SimpleNamespace(data=cols, data_ok=data_ok,
                                       missing_pct=missing_pct, discontinuities=disc)
        try:
            store.save_trades_h5(trades, h5_path, month_key=month)
        except Exception as e:  # noqa: BLE001 - re-raised by process_all
            logger.error(f"Writer failed on {month}: {e}")
            errors.append(e)
            continue
        logger.info(f"Wrote {month} ({len(cols['timestamp']):,} trades)")


def process_all(zip_months, h5_path: str, workers: int):
    """Preprocess ``(zip_path, month)`` pairs in ``workers`` processes (in
    this one where ``workers`` is 1) and write them through one writer thread
    and a queue of two months; the first write error is raised after the
    writer has drained the queue."""
    q = queue.Queue(maxsize=2)
    errors: list = []
    wt = threading.Thread(target=_writer, args=(h5_path, q, errors))
    wt.start()
    try:
        if workers > 1:
            with multiprocessing.get_context("spawn").Pool(workers) as pool:
                for result in pool.imap(_process_task, zip_months):
                    q.put(result)
        else:
            for zm in zip_months:
                q.put(_process_task(zm))
    finally:
        q.put(None)
        wt.join()
    if errors:
        raise errors[0]


def orchestrate_symbol(ticker: str, months, market: str, out_dir: str, workers: int,
                       keep_zips: bool, *, device="cuda"):
    """One ticker's months into ``<out_dir>/<ticker>.h5``: each month's ZIP
    downloaded and checked where it is missing, the months written, their
    1-second klines built on ``device``, and the ZIPs removed unless
    ``keep_zips``."""
    base = _BASE[market]
    h5_path = os.path.join(out_dir, f"{ticker}.h5")
    os.makedirs(out_dir, exist_ok=True)
    zip_months = []
    for month in months:
        fname = f"{ticker}-trades-{month}.zip"
        url = f"{base}/{ticker}/{fname}"
        zip_path = os.path.join(out_dir, fname)
        if not os.path.exists(zip_path):
            download(url, zip_path)
            try:
                cs_path = zip_path + ".CHECKSUM"
                download(url + ".CHECKSUM", cs_path)
                if not verify_checksum(zip_path, cs_path):
                    logger.warning(f"Checksum mismatch for {fname}; re-downloading once")
                    download(url, zip_path)
                    if not verify_checksum(zip_path, cs_path):
                        raise ValueError(f"Checksum verification failed for {fname}")
            except urllib.error.URLError:
                logger.warning(f"No checksum available for {fname}")
        zip_months.append((zip_path, month))

    process_all(zip_months, h5_path, workers)
    AddTimeBarH5(h5_path, device=device).process_all()

    if not keep_zips:
        for zp, _ in zip_months:
            for p in (zp, zp + ".CHECKSUM"):
                if os.path.exists(p):
                    os.remove(p)
    logger.info(f"Done: {h5_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Binance monthly trades -> HDF5 + klines")
    ap.add_argument("--tickers", nargs="+", required=True)
    ap.add_argument("--start", required=True, help="start month YYYY-MM")
    ap.add_argument("--end", required=True, help="end month YYYY-MM")
    ap.add_argument("--market", choices=list(_BASE), default="spot")
    ap.add_argument("--output-dir", default="./data")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--keep-zips", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the klines are built (default: cuda)")
    args = ap.parse_args(argv)

    months = list(month_range(args.start, args.end))
    for ticker in args.tickers:
        orchestrate_symbol(ticker, months, args.market, args.output_dir, args.workers,
                           args.keep_zips, device=args.device)


if __name__ == "__main__":
    main()
