"""The monthly HDF5 trade store, without pandas.

Counterpart of ``finmlkit_tpu/data/store.py``, with its layout, dtypes and
``lzf`` compression, so that a file either package writes loads in the other:

    /trades/YYYY-MM/{timestamp int64, price float64, amount float32, side int8}
    /meta/YYYY-MM           (attrs: record_count, first_timestamp,
                             last_timestamp, data_integrity_ok, missing_pct)
    /integrity/YYYY-MM/     {start_id, end_id, missing_ids, pre_gap_time,
                             post_gap_time}, int64 (times in ns)
    /klines/YYYY-MM/...     (the 1-second bars, ``data/klines.py``)

A month is written or overwritten on its own: the partition is the
checkpoint. Months are keyed from ``datetime64[M]``; times are read as
``bar/data_model._to_ns`` reads them (int ns, ``datetime.datetime``,
``numpy.datetime64`` or ISO strings). Where the JAX module returns
DataFrames, :class:`H5Inspector` returns dicts of numpy columns, times as
int64 ns. ``h5py`` is imported by the functions that open a file, so this
module imports without it.

The process pools load months and scan gaps on the host; they start their
workers by ``spawn``, since the parent may hold a CUDA context, and fall back
to one process as the JAX module does.
"""
import concurrent.futures
import datetime
import multiprocessing
import os
from typing import List, Optional

import numpy as np

from ..bar.data_model import _to_ns
from ..utils.log import get_logger

__all__ = ["save_trades_h5", "load_trades_h5", "H5Inspector"]

logger = get_logger(__name__)

_COMP = dict(compression="lzf")
_COLUMNS = (("timestamp", np.int64), ("price", np.float64), ("amount", np.float32),
            ("side", np.int8))
_INTEGRITY = ("start_id", "end_id", "missing_ids", "pre_gap_time", "post_gap_time")


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the HDF5 store needs h5py, which does not import here") from e
    return h5py


def _pool(workers: int) -> concurrent.futures.ProcessPoolExecutor:
    return concurrent.futures.ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


def month_key_of(ts_ns: int) -> str:
    """``"YYYY-MM"`` of an int ns timestamp."""
    return str(np.datetime64(int(ts_ns), "ns").astype("datetime64[M]"))


def month_bounds(key: str):
    """``(start, end)`` in int ns of the month ``"YYYY-MM"``: its first instant
    and the first instant of the next month."""
    m = np.datetime64(key, "M")
    return (int(m.astype("datetime64[ns]").astype(np.int64)),
            int((m + 1).astype("datetime64[ns]").astype(np.int64)))


def save_trades_h5(trades, filepath: str, *, month_key: Optional[str] = None,
                   mode: str = "a", overwrite_month: bool = True) -> str:
    """Write a :class:`TradesData` (its ``data`` columns, ``data_ok``,
    ``missing_pct`` and ``discontinuities``) under ``/trades/YYYY-MM``, the
    month of its first timestamp unless ``month_key`` names one. An existing
    month is replaced, with its meta and integrity groups, or kept with
    ``overwrite_month=False``. Returns the key, e.g. ``/trades/2021-03``."""
    h5py = _h5py()
    cols = trades.data
    ts = cols["timestamp"]
    if len(ts) == 0:
        raise ValueError("no trades to save")
    if month_key is None:
        month_key = month_key_of(ts[0])
    h5_key = f"/trades/{month_key}"
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)

    with h5py.File(filepath, "w" if mode == "w" else "a") as f:
        if h5_key in f:
            if not overwrite_month:
                logger.info(f"Month {month_key} exists; skipping (overwrite_month=False).")
                return h5_key
            del f[h5_key]
            for k in (f"/meta/{month_key}", f"/integrity/{month_key}"):
                if k in f:
                    del f[k]
        g = f.create_group(h5_key)
        for name, dtype in _COLUMNS:
            if name in cols:
                g.create_dataset(name, data=np.asarray(cols[name]).astype(dtype, copy=False),
                                 **_COMP)

        m = f.create_group(f"/meta/{month_key}")
        m.attrs["record_count"] = len(ts)
        m.attrs["first_timestamp"] = int(ts[0])
        m.attrs["last_timestamp"] = int(ts[-1])
        m.attrs["data_integrity_ok"] = True if trades.data_ok is None else bool(trades.data_ok)
        m.attrs["missing_pct"] = float(trades.missing_pct)

        if trades.discontinuities:
            ig = f.create_group(f"/integrity/{month_key}")
            rows = trades.discontinuities
            for name in _INTEGRITY:
                read = _to_ns if name.endswith("_time") else int
                ig.create_dataset(name, data=np.array([read(r[name]) for r in rows],
                                                      np.int64))
    logger.info(f"Saved {len(ts):,} trades under {h5_key}")
    return h5_key


def _keys_for_timerange(keys: List[str], start_ts: Optional[int],
                        end_ts: Optional[int]) -> List[str]:
    """The month keys whose span [first instant, first instant of the next
    month] meets [start_ts, end_ts] (int ns; None leaves a side open)."""
    out = []
    for k in keys:
        m_start, m_end = month_bounds(k)
        if start_ts is not None and m_end < start_ts:
            continue
        if end_ts is not None and m_start > end_ts:
            continue
        out.append(k)
    return out


def _load_single_group(filepath: str, month_key: str) -> dict:
    """One month's columns, read through its own file handle (a worker's)."""
    with _h5py().File(filepath, "r") as f:
        g = f[f"/trades/{month_key}"]
        return {name: g[name][:] for name in g.keys()}


def _load_groups(filepath, keys, enable_multiprocessing, max_workers) -> dict:
    results = {}
    if enable_multiprocessing and len(keys) > 1:
        try:
            with _pool(max_workers) as ex:
                futs = {ex.submit(_load_single_group, filepath, k): k for k in keys}
                for fut in concurrent.futures.as_completed(futs):
                    k = futs[fut]
                    try:
                        results[k] = fut.result()
                    except Exception as e:  # noqa: BLE001 - a failed month is skipped
                        logger.error(f"Failed loading {k}: {e}")
        except Exception as e:  # noqa: BLE001 - the pool itself failed: load in turn
            logger.warning(f"Parallel load failed ({e}); falling back to sequential.")
            results = {}
    if not results:
        for k in keys:
            try:
                results[k] = _load_single_group(filepath, k)
            except Exception as e:  # noqa: BLE001 - a failed month is skipped
                logger.error(f"Failed loading {k}: {e}")
    return results


def load_trades_h5(filepath: str, *, key: Optional[str] = None, start_time=None,
                   end_time=None, enable_multiprocessing: bool = False,
                   max_workers: int = 4):
    """The trades of the store's months that meet ``[start_time, end_time]``
    (both ends kept), or of the month ``key``, as a :class:`TradesData` built
    from the stored columns without preprocessing (timestamps in ns). A
    column that some of the months lack (``side``) is left out, with a
    warning.

    A month that fails to load is skipped and logged; if every month fails,
    ``ValueError``. ``enable_multiprocessing`` loads the months in a pool of
    ``max_workers`` processes, and in turn if the pool fails."""
    from ..bar.data_model import TradesData

    h5py = _h5py()
    start_ts = None if start_time is None else _to_ns(start_time)
    end_ts = None if end_time is None else _to_ns(end_time)

    with h5py.File(filepath, "r") as f:
        if "trades" not in f:
            raise KeyError(f"No /trades groups in {filepath}")
        all_keys = sorted(f["trades"].keys())
    if key is not None:
        month = key.rsplit("/", 1)[-1]
        if month not in all_keys:
            raise KeyError(f"Month {month} not in store (available: {all_keys})")
        all_keys = [month]
    keys = _keys_for_timerange(all_keys, start_ts, end_ts)
    if not keys:
        raise ValueError(f"No monthly groups overlap requested range in {filepath}")

    results = _load_groups(filepath, keys, enable_multiprocessing, max_workers)
    if not results:
        raise ValueError("All monthly group loads failed.")

    cols = {}
    for name, _ in _COLUMNS:
        parts = [results[k][name] for k in sorted(results) if name in results[k]]
        if len(parts) == len(results):
            cols[name] = np.concatenate(parts)
        elif parts:     # the JAX module concatenates them all the same (R18)
            logger.warning(f"{name} is stored for {len(parts)} of {len(results)} months; "
                           f"left out")
    if start_ts is not None or end_ts is not None:
        ts = cols["timestamp"]
        mask = np.ones(len(ts), bool)
        if start_ts is not None:
            mask &= ts >= start_ts
        if end_ts is not None:
            mask &= ts <= end_ts
        cols = {k: v[mask] for k, v in cols.items()}
    return TradesData(cols["timestamp"], cols["price"], cols["amount"],
                      side=cols.get("side"), timestamp_unit="ns")


def _ns_of(delta) -> int:
    """int ns of a ``datetime.timedelta``, a ``numpy.timedelta64`` or an int."""
    if isinstance(delta, datetime.timedelta):
        return (delta.days * 86_400 + delta.seconds) * 10**9 + delta.microseconds * 1000
    if isinstance(delta, np.timedelta64):
        return int(delta.astype("timedelta64[ns]").astype(np.int64))
    return int(delta)


def _find_gaps_month(args):
    """One month's gaps of more than ``max_gap_ns``: ``(month, start, end,
    duration)`` rows in int ns (a worker's)."""
    filepath, month, max_gap_ns = args
    with _h5py().File(filepath, "r") as f:
        ts = f[f"/trades/{month}/timestamp"][:]
    if len(ts) < 2:
        return []
    d = np.diff(ts)
    return [(month, int(ts[i]), int(ts[i + 1]), int(d[i]))
            for i in np.flatnonzero(d > max_gap_ns)]


class H5Inspector:
    """Diagnostics of the store (``finmlkit_tpu/data/store.py H5Inspector``):
    keys, meta attrs, integrity tables, statistics, gaps and a summary, the
    tables as dicts of numpy columns."""

    def __init__(self, filepath: str):
        self.filepath = filepath

    def list_keys(self) -> List[str]:
        with _h5py().File(self.filepath, "r") as f:
            if "trades" not in f:
                return []
            return [f"/trades/{k}" for k in sorted(f["trades"].keys())]

    def get_metadata(self, key: str) -> dict:
        month = key.rsplit("/", 1)[-1]
        with _h5py().File(self.filepath, "r") as f:
            mk = f"/meta/{month}"
            if mk not in f:
                raise KeyError(f"No metadata for {key}")
            return dict(f[mk].attrs)

    def get_integrity_info(self, key: str) -> Optional[dict]:
        """The month's id gaps of more than a minute, int64 columns (the gap
        times in ns), or None where it has none."""
        month = key.rsplit("/", 1)[-1]
        with _h5py().File(self.filepath, "r") as f:
            ik = f"/integrity/{month}"
            if ik not in f:
                return None
            g = f[ik]
            return {name: g[name][:] for name in g.keys()}

    def get_statistics(self, key: str) -> dict:
        month = key.rsplit("/", 1)[-1]
        with _h5py().File(self.filepath, "r") as f:
            g = f[f"/trades/{month}"]
            px = g["price"][:]
            n = px.shape[0]
            return {
                "records": n,
                "price_min": float(px.min()) if n else np.nan,
                "price_max": float(px.max()) if n else np.nan,
                "total_volume": float(g["amount"][:].sum()) if n else 0.0,
            }

    def inspect_gaps(self, max_gap=None, processes: int = 4) -> dict:
        """Every month's gaps between trades of more than ``max_gap`` (a
        ``datetime.timedelta``, ``numpy.timedelta64`` or int ns; one minute
        by default), scanned a month a process: columns ``month``,
        ``gap_start``, ``gap_end`` and ``duration`` (int64 ns)."""
        max_gap_ns = 60 * 10**9 if max_gap is None else _ns_of(max_gap)
        months = [k.rsplit("/", 1)[-1] for k in self.list_keys()]
        args = [(self.filepath, m, max_gap_ns) for m in months]
        rows = []
        try:
            with _pool(processes) as ex:
                for out in ex.map(_find_gaps_month, args):
                    rows.extend(out)
        except Exception as e:  # noqa: BLE001 - the pool failed: scan in turn
            logger.warning(f"Parallel gap scan failed ({e}); sequential fallback.")
            rows = [g for a in args for g in _find_gaps_month(a)]
        month, start, end, dur = zip(*rows) if rows else ((), (), (), ())
        return {"month": np.array(month, dtype=str),
                "gap_start": np.array(start, np.int64),
                "gap_end": np.array(end, np.int64),
                "duration": np.array(dur, np.int64)}

    def get_integrity_summary(self) -> dict:
        """A row a month: ``month``, ``record_count``, ``data_integrity_ok``,
        ``missing_pct`` and ``n_discontinuities``."""
        rows = []
        for key in self.list_keys():
            try:
                meta = self.get_metadata(key)
            except KeyError:
                meta = {}
            integ = self.get_integrity_info(key)
            rows.append((key.rsplit("/", 1)[-1], meta.get("record_count", np.nan),
                         bool(meta.get("data_integrity_ok", True)),
                         meta.get("missing_pct", 0.0),
                         0 if integ is None else len(integ["start_id"])))
        names = ("month", "record_count", "data_integrity_ok", "missing_pct",
                 "n_discontinuities")
        cols = list(zip(*rows)) if rows else [()] * len(names)
        return {name: np.array(c) for name, c in zip(names, cols)}
