"""Raw trades and their preprocessing, on the host, without pandas.

Counterpart of ``TradesData`` in ``finmlkit_tpu/bar/data_model.py``. The JAX
class keeps a pandas DataFrame with a ``DatetimeIndex``; this one keeps a dict
of numpy columns with the int64 timestamps under ``"timestamp"``, the frame
convention of the port (the bar kits' and the feature framework's dicts).
The preprocessing is the JAX class's, step for step: unit inference and
conversion to ns, the sort by trade id and the drop of duplicate ids, the scan
of id gaps (``missing_pct``, ``data_ok``, ``discontinuities``), the merge of
split executions (``bar/utils.merge_split_trades``), the timestamp resolution
``proc_res``, and the tick-rule sides when no sides are known.

``FootprintData`` is the dense footprint container of the JAX package without
pandas: its tensors (or numpy arrays) as they are, slicing by bar or by time,
the ragged views, ``memory_usage``, and ``get_columns`` in place of ``get_df``.

``save_h5`` and ``load_trades_h5`` write and read the monthly HDF5 store
(``data/store.py``), in the JAX package's layout.
"""
import datetime
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..utils.log import get_logger
from .utils import (comp_trade_side_vector, merge_split_trades,
                    sorted_footprint_columns)

__all__ = ["TradesData", "FootprintData"]

logger = get_logger(__name__)

_UNIT_SCALE = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}
_GAP_NS = 60 * 10**9       # id gaps longer than one minute are discontinuities


def _to_ns(t) -> int:
    """int64 ns since the epoch of ``t``: an int (ns), a ``datetime.datetime``
    (naive means UTC, as the JAX class's naive ``DatetimeIndex``), a
    ``numpy.datetime64`` or an ISO 8601 string."""
    if isinstance(t, (int, np.integer)):
        return int(t)
    if isinstance(t, datetime.datetime):
        if t.tzinfo is not None:
            t = t.astimezone(datetime.timezone.utc).replace(tzinfo=None)
        return int(np.datetime64(t, "ns").astype(np.int64))
    if isinstance(t, (str, np.datetime64)):
        return int(np.datetime64(t, "ns").astype(np.int64))
    raise TypeError(f"cannot read {t!r} as a time")


def _timedelta(ns: int) -> datetime.timedelta:
    """``ns`` as a ``datetime.timedelta``, rounded half up to microseconds (as
    ``pandas.Timedelta.to_pytimedelta`` rounds)."""
    return datetime.timedelta(microseconds=(int(ns) + 500) // 1000)


class TradesData:
    """Raw trades with the JAX class's preprocessing (see the module
    docstring).

    ``ts``, ``px`` and ``qty`` (and ``id``) are numpy arrays of one length.
    ``is_buyer_maker`` gives the sides (a maker buyer is a market sell) and
    ``side`` gives them directly; with ``preprocess=True`` the sides come from
    ``is_buyer_maker`` after the merge, or from the tick rule without it (a
    ``side`` given then is dropped, as the JAX class drops it). ``preprocess``
    needs ``id``. ``proc_res`` floors the ns timestamps to a coarser unit.

    :attr:`data` is a dict of numpy columns: ``timestamp`` (int64; ns after
    preprocessing, the input's unit without it), ``price`` float64,
    ``amount`` float32, ``side`` int8 where known, and ``id`` when given
    without preprocessing. The rows are in the JAX class's order. Kits take a
    ``TradesData`` in place of their columns; :meth:`tensors` copies the
    columns to a device once.

    Two things differ from the JAX class. The JAX class sorts the rows by id
    but merges with ``is_buyer_maker`` in its input order, so its sides
    belong to other trades when the ids were not sorted, and it fails to
    broadcast when duplicate ids were dropped (ROADMAP.md, Queue 3, R13); here
    ``is_buyer_maker`` follows the rows. And there is no ``dt_index``: the
    rows are keyed by their timestamps.
    """

    def __init__(self, ts, px, qty, id=None, *, is_buyer_maker=None, side=None,
                 timestamp_unit: Optional[str] = None, preprocess: bool = False,
                 proc_res: Optional[str] = None, name=None):
        for arr, label in ((ts, "ts"), (px, "px"), (qty, "qty")):
            if not isinstance(arr, np.ndarray):
                raise TypeError(f"{label} must be a np.ndarray")
        if id is not None and not isinstance(id, np.ndarray):
            raise TypeError("id must be a np.ndarray")

        self._start = self._end = None
        self._tensors = {}
        self.name = name
        self._orig_timestamp_unit = timestamp_unit or self._infer_timestamp_unit(ts)
        self._data = {"timestamp": ts.astype(np.int64, copy=False),
                      "price": px.astype(np.float64, copy=False),
                      "amount": qty.astype(np.float32, copy=False)}
        if id is not None:
            self._data["id"] = id
        if side is not None:
            self._data["side"] = np.asarray(side).astype(np.int8, copy=False)

        self.missing_pct = 0
        self.data_ok = None
        self.discontinuities = []
        if preprocess:
            if id is None:
                raise ValueError("id is required if preprocess is True")
            ts = self._timestamps_to_ns(ts)
            ts, px, qty, maker = self._sort_trades(ts, px, qty, id, is_buyer_maker)
            ts, px, qty, sides = merge_split_trades(
                ts.astype(np.int64), px.astype(np.float64), qty.astype(np.float32),
                maker)
            ts = self._apply_timestamp_resolution(ts, proc_res)
            if maker is None:
                sides = comp_trade_side_vector(px)
            self._data = {"timestamp": ts, "price": px, "amount": qty, "side": sides}

    # ------------------------------------------------------------------
    @property
    def data(self) -> dict:
        """The columns in the view range (:meth:`set_view_range`), both ends
        included, or all of them."""
        if self._start is None:
            return self._data
        ts = self._data["timestamp"]
        a = np.searchsorted(ts, self._start, side="left")
        b = np.searchsorted(ts, self._end, side="right")
        return {k: v[a:b] for k, v in self._data.items()}

    @property
    def start_date(self) -> Optional[int]:
        return self._start

    @property
    def end_date(self) -> Optional[int]:
        return self._end

    @property
    def orig_timestamp_unit(self) -> str:
        return self._orig_timestamp_unit

    def set_view_range(self, start, end):
        """Restrict :attr:`data` to the trades with ``start <= timestamp <=
        end``; ``start`` and ``end`` are int ns, ``datetime.datetime``,
        ``numpy.datetime64`` or ISO strings. The timestamps must not
        decrease."""
        start, end = _to_ns(start), _to_ns(end)
        if start >= end:
            raise ValueError("Start timestamp must be before end timestamp.")
        ts = self._data["timestamp"]
        if np.any(ts[1:] < ts[:-1]):
            raise ValueError("a view range needs timestamps in ascending order")
        self._start, self._end = start, end

    def tensors(self, device="cuda") -> dict:
        """The view range's timestamps, prices, amounts and sides as tensors on
        ``device``, copied once and kept for later calls with the same
        device and range."""
        key = (str(torch.device(device)), self._start, self._end)
        if key not in self._tensors:
            self._tensors = {key: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                                   for k, v in self.data.items() if k != "id"}}
        return self._tensors[key]

    # -- the HDF5 store (data/store.py) ------------------------------------
    def save_h5(self, filepath: str, **kwargs) -> str:
        """Write the trades as a month of the store (``store.save_trades_h5``)."""
        from ..data.store import save_trades_h5
        return save_trades_h5(self, filepath, **kwargs)

    @classmethod
    def load_trades_h5(cls, filepath: str, **kwargs) -> "TradesData":
        """Read trades from the store (``store.load_trades_h5``)."""
        from ..data.store import load_trades_h5
        return load_trades_h5(filepath, **kwargs)

    # ------------------------------------------------------------------
    @staticmethod
    def _infer_timestamp_unit(ts) -> str:
        max_ts = np.max(ts) if len(ts) else np.nan
        if max_ts > 1e18:
            return "ns"
        if max_ts > 1e15:
            return "us"
        if max_ts > 1e12:
            return "ms"
        logger.warning("Timestamp unit is set to seconds. Please verify the data.")
        return "s"

    def _timestamps_to_ns(self, ts):
        if self.orig_timestamp_unit not in _UNIT_SCALE:
            raise ValueError(
                f"Invalid timestamp format! Must be one of: {', '.join(_UNIT_SCALE)}")
        return np.multiply(ts, _UNIT_SCALE[self.orig_timestamp_unit], dtype=np.int64)

    def _sort_trades(self, ts, px, qty, ids, maker):
        """Sort by id, drop duplicate ids (the first after the sort stays),
        scan the id gaps, and sort by (timestamp, id) if the timestamps then
        decrease anywhere.

        The JAX class sorts through pandas, whose ``sort_values`` is numpy's
        quicksort: not stable, so among duplicate ids the row kept is the
        one quicksort puts first. The same sort here keeps the same row."""
        self.data_ok = True
        self.discontinuities = []
        order = np.argsort(ids, kind="quicksort")
        ids = ids[order]
        keep = np.ones(len(ids), dtype=bool)
        keep[1:] = ids[1:] != ids[:-1]
        if not keep.all():
            logger.warning(f"{self.name} | Trade IDs contain duplicates.")
            order, ids = order[keep], ids[keep]
            self.data_ok = False
        ts = ts[order]
        self._validate_ids(ids, ts)
        if np.any(ts[1:] < ts[:-1]):
            logger.warning(f"{self.name} | timestamps non-monotonic after id sort.")
            by_time = np.lexsort((ids, ts))
            order, ts = order[by_time], ts[by_time]
        return (ts, px[order], qty[order],
                None if maker is None else np.asarray(maker)[order])

    def _validate_ids(self, ids, ts):
        """The trade-id gap scan: ``missing_pct`` and the gaps of more than a
        minute (``discontinuities``, which clear ``data_ok``)."""
        gap_indices = np.flatnonzero(np.diff(ids) > 1)
        if len(gap_indices) == 0:
            return
        logger.warning(
            f"{self.name} | Found {len(gap_indices):,} discontinuities in trade IDs.")
        gap_sizes = ids[gap_indices + 1] - ids[gap_indices] - 1
        pre_t, post_t = ts[gap_indices], ts[gap_indices + 1]
        tdiff = post_t - pre_t
        large = np.flatnonzero(tdiff > _GAP_NS)
        if len(large):
            self.data_ok = False
            for k in large:
                i = gap_indices[k]
                self.discontinuities.append({
                    "start_id": int(ids[i]),
                    "end_id": int(ids[i + 1]),
                    "missing_ids": int(gap_sizes[k]),
                    "pre_gap_time": int(pre_t[k]),
                    "post_gap_time": int(post_t[k]),
                    "time_interval": _timedelta(tdiff[k]),
                })
        self.missing_pct = float(gap_sizes.sum()) / len(ids) * 100

    def _apply_timestamp_resolution(self, ts, proc_res):
        if proc_res and proc_res != self.orig_timestamp_unit:
            if proc_res not in _UNIT_SCALE:
                raise ValueError(f"Invalid processing resolution: {proc_res}.")
            res = _UNIT_SCALE[proc_res]
            return (ts // res) * res
        return ts


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _nbytes(x) -> int:
    return x.element_size() * x.numel() if torch.is_tensor(x) else np.asarray(x).nbytes


class _TimeIndexer:
    """``FootprintData.loc``: ``fp.loc[start:stop]`` slices by time, ints
    read as int64 ns."""

    def __init__(self, fp):
        self._fp = fp

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("FootprintData.loc takes a slice of times")
        return self._fp._time_slice(key)


@dataclass
class FootprintData:
    """Dense per-bar, per-price-level order flow (``data_model.py:218-345``).

    The grids are ``(n_bars, L)``, masked by each bar's ``n_levels``;
    ``low_level`` is the integer tick of level 0 on the grid of
    ``price_tick``. The fields are the JAX class's, as tensors (on the kit's
    device) or numpy arrays; ``bar_timestamps`` are int64 ns.
    :meth:`from_dict` takes the dict of a kit's ``build_footprints``.

    ``fp[a:b]`` slices the bars by position, or by time when an end is an
    ISO string, a ``datetime.datetime`` or a ``numpy.datetime64``;
    ``fp.loc[a:b]`` slices by time and also reads ints as int64 ns. A time
    slice keeps both ends, as pandas' ``.loc`` does.
    """

    bar_timestamps: object          # (n_bars,) int64 ns
    price_tick: float
    low_level: object               # (n_bars,) int32
    n_levels: object                # (n_bars,) int32
    buy_volumes: object             # (n_bars, L) float32
    sell_volumes: object            # (n_bars, L) float32
    buy_ticks: object               # (n_bars, L) int32
    sell_ticks: object              # (n_bars, L) int32
    buy_imbalances: object          # (n_bars, L) bool
    sell_imbalances: object         # (n_bars, L) bool
    buy_imbalances_sum: object      # (n_bars,) uint16
    sell_imbalances_sum: object     # (n_bars,) uint16
    cot_price_levels: object        # (n_bars,) int32
    imb_max_run_signed: object      # (n_bars,) int16
    vp_skew: object                 # (n_bars,) float64
    vp_gini: object                 # (n_bars,) float64
    extras: dict = field(default_factory=dict)

    _ARRAYS = ("bar_timestamps", "low_level", "n_levels", "buy_volumes",
               "sell_volumes", "buy_ticks", "sell_ticks", "buy_imbalances",
               "sell_imbalances", "buy_imbalances_sum", "sell_imbalances_sum",
               "cot_price_levels", "imb_max_run_signed", "vp_skew", "vp_gini")

    @classmethod
    def from_dict(cls, fp: dict, price_tick: float) -> "FootprintData":
        """The footprints of a kit's ``build_footprints`` (its close
        timestamps under ``"timestamp"``) on the grid of ``price_tick``."""
        return cls(bar_timestamps=fp["timestamp"], price_tick=float(price_tick),
                   **{k: fp[k] for k in cls._ARRAYS if k != "bar_timestamps"})

    def __len__(self):
        return len(self.bar_timestamps)

    def _n_levels(self) -> np.ndarray:
        return _host(self.n_levels).astype(np.int64)

    @property
    def price_levels(self):
        """The integer price levels of every bar, a list of int32 arrays."""
        low, nl = _host(self.low_level), self._n_levels()
        return [np.arange(low[i], low[i] + nl[i], dtype=np.int32)
                for i in range(len(self))]

    def _ragged(self, dense):
        nl = self._n_levels()
        return [dense[i, :nl[i]] for i in range(len(self))]

    @property
    def buy_volumes_ragged(self):
        return self._ragged(self.buy_volumes)

    @property
    def sell_volumes_ragged(self):
        return self._ragged(self.sell_volumes)

    def _slice(self, key) -> "FootprintData":
        return FootprintData(price_tick=self.price_tick, extras=dict(self.extras),
                             **{k: getattr(self, k)[key] for k in self._ARRAYS})

    def _time_slice(self, key: slice) -> "FootprintData":
        ts = _host(self.bar_timestamps).astype(np.int64)
        if len(ts) == 0:
            return self._slice(slice(0, 0))
        start = ts[0] if key.start is None else _to_ns(key.start)
        stop = ts[-1] if key.stop is None else _to_ns(key.stop)
        idx = np.flatnonzero((ts >= start) & (ts <= stop))
        return self._slice(slice(0, 0) if len(idx) == 0
                           else slice(int(idx[0]), int(idx[-1]) + 1))

    @property
    def loc(self) -> _TimeIndexer:
        return _TimeIndexer(self)

    def __getitem__(self, key):
        """Bars by position (an int slice), or by time (see the class)."""
        if not isinstance(key, slice):
            raise TypeError("FootprintData takes a slice of bars or of times")
        timelike = (str, datetime.datetime, np.datetime64)
        if isinstance(key.start, timelike) or isinstance(key.stop, timelike):
            return self._time_slice(key)
        return self._slice(key)

    def get_columns(self) -> dict:
        """The footprints flattened to one row a (bar, level) as numpy
        columns: ``price_level`` (in price units), ``sell_ticks``,
        ``buy_ticks``, ``sell_volume``, ``buy_volume``, ``sell_imbalance``,
        ``buy_imbalance``, and the index arrays ``bar_idx`` and
        ``bar_datetime_idx`` (int64 ns), in the row order of the JAX class's
        ``get_df``: bar time ascending, price descending."""
        nl = self._n_levels()
        L = self.buy_volumes.shape[1]
        bar_idx = np.repeat(np.arange(len(self)), nl)
        level_in_bar = (np.concatenate([np.arange(k, dtype=np.int64) for k in nl])
                        if len(self) else np.empty(0, dtype=np.int64))
        flat = bar_idx * L + level_in_bar
        price_level = (np.repeat(_host(self.low_level), nl) + level_in_bar) \
            * self.price_tick

        def col(name):
            return _host(getattr(self, name)).reshape(-1)[flat]

        columns = {
            "price_level": price_level,
            "sell_ticks": col("sell_ticks"),
            "buy_ticks": col("buy_ticks"),
            "sell_volume": col("sell_volumes"),
            "buy_volume": col("buy_volumes"),
            "sell_imbalance": col("sell_imbalances"),
            "buy_imbalance": col("buy_imbalances"),
        }
        bar_ns = np.repeat(_host(self.bar_timestamps).astype(np.int64), nl)
        return sorted_footprint_columns(columns, bar_idx, bar_ns)

    def memory_usage(self) -> int:
        """Bytes of the dense tensors."""
        return sum(_nbytes(getattr(self, k)) for k in self._ARRAYS)
