"""The labelling kit: ``TBMLabel`` and ``SampleWeights`` over frames.

Counterpart of ``finmlkit_tpu/label/kit.py``. A frame is a dict of equal-length
1-D tensors on one device with int64 ns timestamps under ``"timestamp"``, where
the JAX kit takes a DataFrame with a ``DatetimeIndex`` (the port's feature
frames, ``FeatureKit.build``'s output, are such frames); a Series is a 1-D
tensor, and "the same index" is "the same length". The kit keeps the JAX
kit's validations and their messages, its preprocessing (the leading-NaN trim
and the min-return filter, ``kit.py:61-73``), the drop of events whose
vertical barrier passes the last trade (``:119-123``), the event indices by
``searchsorted`` (``:130-134``), the output columns (``:151-158``) and the
final weights (``:195-243``). The numeric work runs on the frame's device:
``label/tbm.triple_barrier`` on the trades, ``label/weights`` with kernel S
(``cumsum=``; its plain version is ``ops.prefix_scan.fast_cumsum_plain``).
The trades are a port :class:`~finmlkit_tpu_torch.bar.data_model.TradesData`,
copied to that device once (``TradesData.tensors``).
"""
import datetime

import numpy as np
import torch

from ..bar.data_model import TradesData
from ..ops.prefix_scan import fast_cumsum
from .tbm import triple_barrier
from .weights import (average_uniqueness, class_balance_weights, return_attribution,
                      time_decay)

__all__ = ["TBMLabel", "SampleWeights"]

TIMESTAMP = "timestamp"


def _seconds(t) -> float:
    """A span as float seconds: a ``datetime.timedelta`` or a number."""
    return t.total_seconds() if isinstance(t, datetime.timedelta) else float(t)


def seconds_to_ns(x: float) -> int:
    """``pandas.Timedelta(x, unit="s")`` in ns, without pandas: the whole
    seconds exactly, the fraction rounded to 9 decimals first and its ns then
    truncated. It is not ``int(x * 1e9)``: 2.5e-9 s gives 3 ns."""
    base = int(x)
    frac = round(x - base, 9)
    return base * 10**9 + int(frac * 1e9)


def _first_valid(v: torch.Tensor):
    """Position of the first non-NaN value, or None (an integer column has
    no NaN)."""
    if v.shape[0] == 0:
        return None
    if not v.is_floating_point():
        return 0
    ok = ~torch.isnan(v)
    return int(ok.to(torch.int8).argmax()) if bool(ok.any()) else None


def _rows(frame: dict, idx: torch.Tensor) -> dict:
    return {k: v[idx] for k, v in frame.items()}


class TBMLabel:
    """Triple-Barrier Method labelling of the events in a features frame.

    ``features`` is a frame (see the module docstring) whose rows are the
    events; ``target_ret_col`` names its target returns. ``vertical_barrier``
    and ``min_close_time`` are ``datetime.timedelta`` or float seconds.
    ``is_meta`` labels the ``side`` column's bets (an integer column) 0 or 1.
    """

    def __init__(self, features: dict, target_ret_col: str, min_ret: float,
                 horizontal_barriers: tuple, vertical_barrier,
                 min_close_time=datetime.timedelta(seconds=1), is_meta: bool = False):
        if target_ret_col not in features:
            raise ValueError(f"Target column '{target_ret_col}' not found in features frame.")
        ts = features.get(TIMESTAMP)
        if not torch.is_tensor(ts) or ts.dtype != torch.int64:
            raise ValueError("Features must hold int64 ns timestamps under 'timestamp'.")
        if not isinstance(horizontal_barriers, tuple) or len(horizontal_barriers) != 2:
            raise ValueError("Horizontal barriers must be a tuple of two floats (bottom, top).")
        if min_ret < 0.0:
            raise ValueError("Minimum return must be non-negative.")
        if is_meta:
            if "side" not in features:
                raise ValueError("For meta labeling, 'side' column must be present in features frame.")
            side = features["side"]
            if side.is_floating_point() or side.is_complex() or side.dtype == torch.bool:
                raise ValueError("The 'side' column must be of integer type (e.g., -1, 0, 1).")

        self._orig_features = self._preprocess_features(
            features, target_ret_col, min_ret, horizontal_barriers)
        self._features = self._orig_features
        self.target_ret_col = target_ret_col
        self.min_ret = min_ret
        self.horizontal_barriers = horizontal_barriers
        self.vertical_barrier = _seconds(vertical_barrier)
        self.min_close_time_sec = _seconds(min_close_time)
        self.is_meta = is_meta
        self._out = None

    @staticmethod
    def _preprocess_features(x, target_ret_col, min_ret, horizontal_barriers):
        """Trim the rows before the latest first valid value of any column,
        then keep the rows whose target times the larger barrier reaches
        ``min_ret``."""
        ts = x[TIMESTAMP]
        first = [p for c, v in x.items() if c != TIMESTAMP
                 for p in (_first_valid(v),) if p is not None]
        if not first:
            raise ValueError("All columns contain only NaN values.")
        t_max = ts[torch.tensor(first, device=ts.device)].max()
        start = int((ts == t_max).to(torch.int8).argmax())   # its first row
        x = {k: v[start:] for k, v in x.items()}
        max_mult = float(np.max(horizontal_barriers))
        keep = torch.nonzero(x[target_ret_col].abs() * max_mult >= min_ret).reshape(-1)
        x = _rows(x, keep)
        if keep.shape[0] == 0:
            raise ValueError("No valid events found after filtering by minimum return "
                             "and removing leading NaNs.")
        if bool(torch.isnan(x[target_ret_col]).any()):
            raise ValueError(f"Target return column '{target_ret_col}' contains NaN values.")
        return x

    # ------------------------------------------------------------------
    @property
    def event_count(self) -> int:
        return self._features[TIMESTAMP].shape[0]

    @property
    def first_event_timestamp(self):
        """The first event's int64 ns timestamp, or None."""
        return int(self._features[TIMESTAMP][0]) if self.event_count else None

    @property
    def last_event_timestamp(self):
        """The last event's int64 ns timestamp, or None."""
        return int(self._features[TIMESTAMP][-1]) if self.event_count else None

    @property
    def event_range(self) -> str:
        def at(t):
            return None if t is None else np.datetime64(t, "ns")
        return (f"From {at(self.first_event_timestamp)} to "
                f"{at(self.last_event_timestamp)} ({self.event_count} events)")

    @property
    def features(self) -> dict:
        return self._features

    @property
    def target_returns(self) -> torch.Tensor:
        return self._features[self.target_ret_col]

    @property
    def labels(self) -> torch.Tensor:
        if self._out is None:
            raise ValueError("Labels have not been computed yet. Call `compute_labels()` first.")
        return self._out["labels"]

    @property
    def event_returns(self) -> torch.Tensor:
        if self._out is None or "returns" not in self._out:
            raise ValueError("Log returns have not been computed yet. Call `compute_labels()` first.")
        return self._out["returns"]

    @property
    def full_output(self) -> dict:
        if self._out is None:
            raise ValueError("Labels have not been computed yet.")
        return self._out

    # ------------------------------------------------------------------
    def _drop_trailing_events(self, trades: TradesData) -> dict:
        last_ts = int(trades.data["timestamp"][-1])
        ts = self._orig_features[TIMESTAMP]
        keep = torch.nonzero(ts + seconds_to_ns(self.vertical_barrier) <= last_ts)
        return _rows(self._orig_features, keep.reshape(-1))

    def compute_labels(self, trades: TradesData):
        """Label the events on the trades' prices. Returns ``(features used,
        output frame)``: the output has the events' ``timestamp``,
        ``touch_time`` (the touching trade's int64 ns), ``event_idx``,
        ``touch_idx``, ``labels``, ``returns`` and
        ``vertical_touch_weights``."""
        if not isinstance(trades, TradesData):
            raise ValueError("Trades must be an instance of TradesData.")
        self._features = self._drop_trailing_events(trades)
        ev_ts = self._features[TIMESTAMP]
        t = trades.tensors(ev_ts.device)
        if "event_idx" in self._features:
            event_idx = self._features["event_idx"].to(torch.int64)
        else:
            event_idx = torch.searchsorted(t["timestamp"], ev_ts)

        labels, touch_idx, rets, max_rb_ratios = triple_barrier(
            timestamps=t["timestamp"], close=t["price"], event_idxs=event_idx,
            targets=self.target_returns, horizontal_barriers=self.horizontal_barriers,
            vertical_barrier=self.vertical_barrier,
            min_close_time_sec=self.min_close_time_sec,
            side=self._features["side"].to(torch.int8) if self.is_meta else None,
            min_ret=self.min_ret)
        self._out = {TIMESTAMP: ev_ts, "touch_time": t["timestamp"][touch_idx],
                     "event_idx": event_idx, "touch_idx": touch_idx, "labels": labels,
                     "returns": rets, "vertical_touch_weights": max_rb_ratios}
        return self._features, self.full_output

    def compute_weights(self, trades: TradesData, normalized: bool = False, *,
                        cumsum=fast_cumsum) -> dict:
        """:meth:`SampleWeights.compute_info_weights` of the labelled events."""
        return SampleWeights.compute_info_weights(trades, self._out, normalized,
                                                  cumsum=cumsum)


class SampleWeights:
    """Uniqueness, return attribution, time decay and class balance weights
    of labelled events (``kit.py:166-243``)."""

    @staticmethod
    def compute_info_weights(trades: TradesData, labels: dict, normalize: bool = False,
                             *, cumsum=fast_cumsum) -> dict:
        """Average uniqueness and return attribution of the events of
        ``labels`` (a frame with ``event_idx`` and ``touch_idx``) over the
        trades. ``cumsum`` defaults to kernel S."""
        if not isinstance(trades, TradesData):
            raise ValueError("Trades must be an instance of TradesData.")
        if not isinstance(labels, dict):
            raise ValueError("Events must be a frame (a dict of tensors).")
        if "event_idx" not in labels or "touch_idx" not in labels:
            raise ValueError("Events frame must contain 'event_idx' and 'touch_idx' columns.")
        ev, touch = labels["event_idx"], labels["touch_idx"]
        t = trades.tensors(ev.device)
        avg_u, concurrency = average_uniqueness(t["timestamp"], ev, touch, cumsum=cumsum)
        info_w = return_attribution(ev, touch, t["price"], concurrency,
                                    normalize=normalize, cumsum=cumsum)
        out = {TIMESTAMP: labels[TIMESTAMP]} if TIMESTAMP in labels else {}
        return {**out, "avg_uniqueness": avg_u, "return_attribution": info_w}

    @staticmethod
    def compute_final_weights(avg_uniqueness: torch.Tensor,
                              time_decay_intercept: float = 1.0,
                              return_attribution: torch.Tensor = None,
                              vertical_touch_weights: torch.Tensor = None,
                              labels: torch.Tensor = None, *, cumsum=fast_cumsum) -> dict:
        """Time decay over the uniqueness, times the return attribution
        (scaled to mean 1) or the uniqueness, times the vertical-touch
        weights, scaled to mean 1, then balanced over ``labels``' classes.
        Returns a dict with ``time_decay_weights``, the inputs used and
        ``weights``. ``cumsum`` (the time decay's) defaults to kernel S."""
        if not torch.is_tensor(avg_uniqueness):
            raise ValueError("avg_uniqueness must be a 1-D tensor.")
        if not isinstance(time_decay_intercept, (int, float)):
            raise ValueError("time_decay_intercept must be a numeric value.")
        if not -1.0 <= time_decay_intercept <= 1.0:
            raise ValueError("time_decay_intercept must lie in [-1, 1]")
        for s, nm in ((return_attribution, "return_attribution"),
                      (vertical_touch_weights, "vertical_touch_weights"),
                      (labels, "labels")):
            if s is not None:
                if not torch.is_tensor(s):
                    raise ValueError(f"{nm} must be a 1-D tensor.")
                if s.shape != avg_uniqueness.shape:
                    raise ValueError(f"avg_uniqueness and {nm} must have the same length.")

        n_events = avg_uniqueness.shape[0]
        tdw = time_decay(avg_uniqueness, time_decay_intercept, cumsum=cumsum)
        out = {"time_decay_weights": tdw}
        if return_attribution is not None:
            total = torch.nansum(return_attribution)      # a Series' sum skips NaN
            if float(total) <= 0:
                raise ValueError("Return attribution sum is zero or negative, cannot normalize.")
            ra = return_attribution * n_events / total
            out["return_attribution"] = ra
            combined = tdw * ra
        else:
            combined = tdw * avg_uniqueness
        if vertical_touch_weights is not None:
            out["vertical_touch_weights"] = vertical_touch_weights
            combined = combined * vertical_touch_weights

        mean_w = combined.mean()
        if float(mean_w) <= 0:
            raise ValueError("Mean of combined weights is zero or negative, cannot normalize.")
        base_weights = combined / mean_w
        out["weights"] = (class_balance_weights(labels, base_weights)[3]
                          if labels is not None else base_weights)
        return out
