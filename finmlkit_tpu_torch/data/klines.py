"""1-second klines: built on the device, stored by month, read and resampled.

Counterpart of ``finmlkit_tpu/data/klines.py``. :class:`AddTimeBarH5` builds
each stored month's 1-second bars with the port's ``TimeBarKit``
(:func:`build_klines`: kernel B for the products, kernel S for the sort
medians' bar ids) and writes them under ``/klines/YYYY-MM`` with the JAX
package's datasets and ``/klines_meta`` attrs. :class:`TimeBarReader` reads a
range of them as a frame, the port's dict of equal-length 1-D tensors with
the int64 ns timestamps under ``"timestamp"``, and resamples it on its device
with :func:`resample`, one vectorized pass in place of the JAX module's
pandas ``groupby`` and its Python median a group.

``h5py`` is imported where a file is opened, so :func:`build_klines` and
:func:`resample` run without it.
"""
import re
from fractions import Fraction
from typing import Dict, List, Optional

import numpy as np
import torch

from ..bar.data_model import _to_ns
from ..ops.prefix_scan import fast_cumsum, fast_cumsum_plain
from ..ops.segment import _sortable_bits
from ..utils.log import get_logger
from .store import H5Inspector, _h5py

__all__ = ["AddTimeBarH5", "TimeBarReader", "build_klines", "resample",
           "parse_timeframe", "KLINE_COLS"]

logger = get_logger(__name__)

KLINE_COLS = ("open", "high", "low", "close", "volume", "trades",
              "median_trade_size", "vwap")
_KLINE_DTYPES = (torch.float64,) * 4 + (torch.float32, torch.int64, torch.float64,
                                         torch.float64)
_DAY_NS = 86_400 * 10**9


def build_klines(trades, *, device="cuda", plain: bool = False) -> dict:
    """The 1-second bars of a :class:`TradesData` as :class:`AddTimeBarH5`
    builds them: ``TimeBarKit(trades, 1.0).build_ohlcv()`` on ``device``,
    through the kernels or, with ``plain=True``, their plain versions."""
    from ..bar.kit import TimeBarKit
    return TimeBarKit(trades, 1.0, device=device, plain=plain).build_ohlcv()


# --- timeframes -------------------------------------------------------------

# the units of DatetimeIndex.floor's fixed frequencies in pandas 3, in ns: "ns",
# "us", "min" and "D" in any case, "ms", "s" and "h" in lower case only (pandas
# reads "MS" as month start and no longer reads "H", "T", "S", "L", "U" or "N")
_UNITS = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 10**9, "min": 60 * 10**9,
          "h": 3_600 * 10**9, "d": _DAY_NS}
_ANY_CASE = {"ns", "us", "min", "d"}
_PART = re.compile(r"\s*(\d*\.?\d*)\s*([A-Za-z]+)\s*")


def _unit_ns(name: str) -> Optional[int]:
    low = name.lower()
    if low in _ANY_CASE:
        return _UNITS[low]
    return _UNITS.get(name)


def parse_timeframe(timeframe: str) -> int:
    """The length in ns of a fixed frequency as ``DatetimeIndex.floor`` reads
    it: one or more parts ``[multiplier]unit`` (``"1min"``, ``"90s"``,
    ``"1.5h"``, ``"1h30min"``), with the units of ``_UNITS``. A decimal
    multiplier must give whole ns. Calendar frequencies (``"W"``, ``"M"``,
    ``"ME"``, ``"MS"``), the spellings pandas 3 dropped and anything else
    raise ``ValueError``, as do lengths of zero or less, where pandas' floor
    would not group."""
    if not isinstance(timeframe, str):
        raise ValueError(f"timeframe must be a string, not {timeframe!r}")
    text = timeframe.strip()
    sign = -1 if text.startswith("-") else 1
    if text[:1] in ("+", "-"):
        text = text[1:]
        if text[:1].isspace():
            raise ValueError(f"Invalid frequency: {timeframe!r}")
    pos, total = 0, Fraction(0)
    for m in _PART.finditer(text):
        unit = _unit_ns(m.group(2))
        mult = m.group(1)
        if m.start() != pos or unit is None or mult == ".":
            raise ValueError(f"Invalid frequency: {timeframe!r}")
        total += (Fraction(mult) if mult else 1) * unit
        pos = m.end()
    if pos != len(text) or pos == 0 or total.denominator != 1:
        raise ValueError(f"Invalid frequency: {timeframe!r}")
    ns = sign * int(total)
    if ns >= 2**63:
        raise ValueError(f"timeframe {timeframe!r} is longer than int64 ns hold")
    if ns <= 0:
        raise ValueError(f"timeframe {timeframe!r} is not a positive length")
    return ns


# --- the resample -----------------------------------------------------------

def _first_last(x, pos, lengths, n):
    """The first and the last non-NaN value of ``x`` in every group (NaN where
    the group has none)."""
    nan = torch.isnan(x)
    first = torch.segment_reduce(pos.masked_fill(nan, n), "min", lengths=lengths)
    last = torch.segment_reduce(pos.masked_fill(nan, -1), "max", lengths=lengths)
    return tuple(x[p.clamp(0, n - 1).to(torch.int64)].masked_fill((p < 0) | (p >= n),
                                                                  float("nan"))
                 for p in (first, last))


def _extreme(x, lengths, how):
    """Max or min of ``x`` over every group, NaNs skipped (NaN where the
    group has none)."""
    nan = torch.isnan(x)
    r = torch.segment_reduce(x.masked_fill(nan, float("-inf" if how == "max" else "inf")),
                             how, lengths=lengths)
    valid = torch.segment_reduce((~nan).to(x.dtype), "sum", lengths=lengths)
    return r.masked_fill(valid == 0, float("nan"))


def resample(frame: dict, timeframe: str, *, plain: bool = False) -> dict:
    """The 1-second klines ``frame`` (sorted by ``"timestamp"``) in groups of
    ``timeframe`` (:func:`parse_timeframe`), on the frame's device, as the
    JAX module's ``_resample`` (``klines.py:181-207``) computes them.

    A group holds the rows whose ``floor(timestamp / f) * f`` (floor division
    from the epoch) is one value, and starts where that value changes; it is
    stamped with it. ``open`` and ``close`` are the first and last non-NaN
    values, ``high`` and ``low`` the extrema without NaNs, ``volume`` float32
    and ``trades`` the sums, ``vwap`` the float32 of ``sum(vwap * volume) /
    sum(volume)``, and ``median_trade_size`` the float32 of the
    trade-count-weighted median of the seconds' medians: sorted by size within
    the group, the first row whose running count reaches half the group's
    (NaN where it has no trade). Groups whose ``open`` is NaN are dropped.

    The float sums are segment sums (``torch.segment_reduce``) in float64,
    NaNs taken as 0, rounded once: pandas sums the float32 volume in float32
    with compensation, and divides by that sum, so the two differ by about a
    float32 ulp. The median sorts one int64 key ``(group << 32) |
    sortable_bits(float32 size)``, takes the running counts in that order as
    one int64 prefix (kernel S, or with ``plain=True`` its plain version,
    ``torch.cumsum``), exact, and finds each group's row with one
    ``searchsorted``. Sizes that one float32 holds may sort in any order:
    the row found then has that float32 all the same.
    """
    f = parse_timeframe(timeframe)
    cumsum = fast_cumsum_plain if plain else fast_cumsum
    ts = frame["timestamp"]
    dev, n = ts.device, ts.shape[0]
    if n == 0:
        return {"timestamp": ts.clone(), **{k: frame[k].clone() for k in
                                            ("open", "high", "low", "close", "volume",
                                             "trades")},
                "vwap": frame["vwap"].to(torch.float32),
                "median_trade_size": frame["median_trade_size"].to(torch.float32)}
    f64 = torch.float64
    key = torch.div(ts, f, rounding_mode="floor") * f
    starts = torch.ones(n, dtype=torch.int32, device=dev)
    starts[1:] = (key[1:] != key[:-1]).to(torch.int32)
    gid = cumsum(starts).to(torch.int64) - 1
    begin = torch.nonzero(starts).squeeze(1)
    lengths = torch.diff(begin, append=torch.tensor([n], device=dev))
    end = begin + lengths - 1

    pos = torch.arange(n, dtype=f64, device=dev)
    open_, _ = _first_last(frame["open"], pos, lengths, n)
    _, close = _first_last(frame["close"], pos, lengths, n)
    high = _extreme(frame["high"], lengths, "max")
    low = _extreme(frame["low"], lengths, "min")
    vol64 = torch.nan_to_num(frame["volume"].to(f64), nan=0.0)
    vol_sum = torch.segment_reduce(vol64, "sum", lengths=lengths)
    pv = torch.nan_to_num(frame["vwap"].to(f64) * frame["volume"].to(f64), nan=0.0)
    vwap = (torch.segment_reduce(pv, "sum", lengths=lengths) / vol_sum).to(torch.float32)

    # the weighted median: one sort keeps every group on its rows, sizes ascending
    size = frame["median_trade_size"].to(torch.float32)
    size = torch.where(torch.isnan(size), size.new_tensor(float("nan")), size)
    order = torch.sort((gid << 32) | _sortable_bits(size)).indices
    p = cumsum(frame["trades"].to(torch.int64)[order])
    base = torch.where(begin > 0, p[(begin - 1).clamp(min=0)], torch.zeros_like(begin))
    total = p[end] - base
    row = torch.searchsorted(p, base + (total + 1) // 2).clamp(max=n - 1)
    median = torch.where(total > 0, size[order[row]], size.new_tensor(float("nan")))

    out = {"timestamp": key[begin], "open": open_, "high": high, "low": low,
           "close": close, "volume": vol_sum.to(torch.float32), "trades": total,
           "vwap": vwap, "median_trade_size": median}
    keep = ~torch.isnan(open_)
    return {k: v[keep] for k, v in out.items()}


# --- the store --------------------------------------------------------------

class AddTimeBarH5:
    """Build the 1-second bars of the store's months (all, or ``keys``) and
    write them under ``/klines/YYYY-MM`` with ``/klines_meta/YYYY-MM`` attrs
    (``record_count``, ``first_timestamp``, ``last_timestamp``,
    ``original_trades_key``). The bars are built on ``device`` ("cuda"
    unless the caller asks for the CPU)."""

    def __init__(self, h5_path: str, keys: Optional[List[str]] = None, *,
                 device="cuda"):
        self.h5_path = h5_path
        self.device = device
        self.keys = self._check_keys(keys)

    def _check_keys(self, keys):
        available = H5Inspector(self.h5_path).list_keys()
        if keys:
            keys = [k if k.startswith("/trades/") else f"/trades/{k}" for k in keys]
            missing = [k for k in keys if k not in available]
            if missing:
                raise KeyError(f"Missing keys: {missing}\nAvailable keys: {available}")
            return keys
        return available

    def process_key(self, key: str, overwrite: bool = False) -> bool:
        """Build and write one month's bars; False where they exist and
        ``overwrite`` is not set."""
        from .store import load_trades_h5

        h5py = _h5py()
        if not key.startswith("/trades/"):
            key = f"/trades/{key}"
        month_key = key.rsplit("/", 1)[-1]
        timebar_key = f"/klines/{month_key}"
        with h5py.File(self.h5_path, "r") as f:
            if timebar_key in f and not overwrite:
                logger.info(f"Time bars already exist for {month_key}. Skipping.")
                return False

        logger.info(f"Building 1-second time bars for {month_key}...")
        trades = load_trades_h5(self.h5_path, key=month_key)
        bars = {k: v.cpu().numpy() for k, v in
                build_klines(trades, device=self.device).items()}
        ts = bars["timestamp"]

        with h5py.File(self.h5_path, "a") as f:
            if timebar_key in f:
                del f[timebar_key]
            g = f.create_group(timebar_key)
            g.create_dataset("timestamp", data=ts, compression="lzf")
            for col in KLINE_COLS:
                g.create_dataset(col, data=bars[col], compression="lzf")
            meta_key = f"/klines_meta/{month_key}"
            if meta_key in f:
                del f[meta_key]
            m = f.create_group(meta_key)
            m.attrs["record_count"] = len(ts)
            m.attrs["first_timestamp"] = int(ts[0])
            m.attrs["last_timestamp"] = int(ts[-1])
            m.attrs["original_trades_key"] = key
        logger.info(f"Added time bars for {month_key}: {len(ts)} bars.")
        return True

    def process_all(self, overwrite: bool = False) -> Dict[str, bool]:
        """:meth:`process_key` of every key; a month that fails is logged and
        gives False."""
        results = {}
        for key in self.keys:
            try:
                results[key] = self.process_key(key, overwrite)
            except Exception as e:  # noqa: BLE001 - one month's failure is reported
                logger.error(f"Error processing {key}: {e}")
                results[key] = False
        ok = sum(results.values())
        logger.info(f"Processed {len(results)} keys with {ok} successes.")
        return results


class TimeBarReader:
    """Read the store's 1-second klines as a frame on ``device`` ("cuda"
    unless the caller asks for the CPU), filtered to a range and resampled
    (:func:`resample`; ``plain=True`` runs its plain version)."""

    def __init__(self, h5_path: str, *, device="cuda", plain: bool = False):
        self.h5_path = h5_path
        self.device = torch.device(device)
        self.plain = plain

    def list_keys(self) -> List[str]:
        with _h5py().File(self.h5_path, "r") as f:
            if "klines" not in f:
                return []
            return [f"/klines/{k}" for k in sorted(f["klines"].keys())]

    def _meta(self):
        """``(month, first, last)`` of every month's klines, int ns."""
        with _h5py().File(self.h5_path, "r") as f:
            if "klines_meta" not in f:
                return None
            return [(k, int(f[f"/klines_meta/{k}"].attrs["first_timestamp"]),
                     int(f[f"/klines_meta/{k}"].attrs["last_timestamp"]))
                    for k in f["klines_meta"]]

    def get_time_range(self):
        """The first and the last kline timestamp of the store, int ns."""
        meta = self._meta()
        if meta is None:
            raise ValueError("No klines metadata found.")
        return min(m[1] for m in meta), max(m[2] for m in meta)

    def _find_relevant_keys(self, start_ns=None, end_ns=None) -> List[str]:
        return sorted(f"/klines/{k}" for k, first, last in self._meta() or ()
                      if (start_ns is None or last >= start_ns)
                      and (end_ns is None or first <= end_ns))

    def _load_key(self, key: str) -> dict:
        with _h5py().File(self.h5_path, "r") as f:
            g = f[key]
            return {c: g[c][:] for c in ("timestamp", *KLINE_COLS)}

    def _empty(self) -> dict:
        return {"timestamp": torch.empty(0, dtype=torch.int64, device=self.device),
                **{c: torch.empty(0, dtype=d, device=self.device)
                   for c, d in zip(KLINE_COLS, _KLINE_DTYPES)}}

    def read(self, start_time=None, end_time=None,
             timeframe: Optional[str] = None) -> dict:
        """The klines with ``start_time <= timestamp <= end_time`` (times as
        ``_to_ns`` reads them; None leaves a side open), resampled to
        ``timeframe`` where one is given. An end at midnight reads the whole
        day it starts, and then a daily ``timeframe`` (one that ends in "D")
        keeps the days before it (``klines.py:156-159``, ``:175-178``). No
        klines in range give a frame of empty columns."""
        start = None if start_time is None else _to_ns(start_time)
        end = None if end_time is None else _to_ns(end_time)
        original_end = None
        if end is not None and (end // 1000) % (_DAY_NS // 1000) == 0:
            original_end = end
            end = end + _DAY_NS - 1000

        keys = self._find_relevant_keys(start, end)
        if not keys:
            logger.warning(f"No data found for time range: {start_time} to {end_time}")
            return self._empty()
        parts = [self._load_key(k) for k in keys]
        cols = {c: np.concatenate([p[c] for p in parts]) for c in parts[0]}
        ts = cols["timestamp"]
        mask = np.ones(len(ts), bool)
        if start is not None:
            mask &= ts >= start
        if end is not None:
            mask &= ts <= end
        frame = {c: torch.from_numpy(np.ascontiguousarray(v[mask])).to(self.device)
                 for c, v in cols.items()}
        if timeframe is None:
            return frame
        if frame["timestamp"].shape[0] == 0:
            return self._empty()
        out = resample(frame, timeframe,
                       plain=self.plain)
        if timeframe.upper().endswith("D") and original_end is not None:
            keep = out["timestamp"] <= original_end - _DAY_NS
            out = {k: v[keep] for k, v in out.items()}
        return out
