"""Transform catalog: the bar-level indicators as feature transforms.

Counterpart of ``finmlkit_tpu/feature/transforms.py``: the same 39 classes,
constructor signatures, defaults and output names. Each computes the JAX
package's ``_jax`` tier in PyTorch, mostly one call into ``feature.kernels``,
on the frame's device. Where that tier is host code, the port has its own
device form: ``CUSUMTest``'s ages (bars since the last flag, a ``cummax``),
``BarDurationEWMA``, and ``DailyGap`` and ``ORBBreak``, whose JAX tier is the
pandas reference's calendar logic, as vectorised forms on int64 UTC day
numbers that equal it. Output dtypes follow the JAX package where they carry
meaning (bool flags, uint8 ages, int8 run lengths); the rest is float64
(VPIN float32, as its kernel returns it).
"""
import datetime
import math
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import kernels as K
from .base import (BaseTransform, MIMOTransform, MISOTransform, SIMOTransform,
                   SISOTransform, as_frame)
from .kernels._rolling import roll_sum, sliding_windows, warmup_nan

_DAY_NS = 86_400 * 10**9
_F64 = torch.float64


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(_F64)


def _before(n: int, periods: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) < periods


class Identity(BaseTransform):
    """Return a column unchanged."""

    def __init__(self, input_col: str = "close"):
        if not isinstance(input_col, str):
            raise TypeError("Input column must be a string.")
        super().__init__(input_col, input_col)

    def __call__(self, x, *, device="cuda"):
        x = as_frame(x, device)
        self._validate_input(x)
        return x[self.requires[0]]

    def _validate_input(self, x):
        if self.requires[0] not in x:
            raise ValueError(f"Input DataFrame must contain the column '{self.requires[0]}'.")
        return True

    @property
    def output_name(self) -> str:
        return self.produces[0]


class Lag(SISOTransform):
    """Lagged values; a negative lag wraps, as ``jnp.roll`` does."""

    def __init__(self, periods: int = 1, input_col: str = "close"):
        super().__init__(input_col, f"lag{periods}")
        self.periods = periods

    def _compute(self, x):
        arr = _f64(self._prepare_input(x))
        return torch.where(_before(arr.shape[0], self.periods, arr.device), torch.nan,
                           torch.roll(arr, self.periods))


class ReturnT(SISOTransform):
    """Returns over a time window on an irregular series."""

    def __init__(self, window: datetime.timedelta = datetime.timedelta(seconds=1e-6),
                 is_log: bool = False, input_col: str = "close"):
        window_sec = window.total_seconds()
        output_col = f"ret{window_sec}s" if window_sec > 1e-6 else "ret1"
        super().__init__(input_col, output_col)
        self.window = window  # kept for the config (ROADMAP R12)
        self.window_sec = window_sec
        self.is_log = is_log

    def _compute(self, x):
        return K.comp_lagged_returns(self._get_timestamps(x), self._prepare_input(x),
                                     self.window_sec, self.is_log)


class Return(SISOTransform):
    """Fixed-period returns."""

    def __init__(self, periods: int = 1, input_col: str = "close", is_log: bool = False):
        super().__init__(input_col, f"ret{periods}")
        self.periods = periods
        self.is_log = is_log

    def _compute(self, x):
        arr = _f64(self._prepare_input(x))
        lag = torch.roll(arr, self.periods)
        out = torch.log(arr / lag) if self.is_log else arr / lag - 1.0
        return torch.where(_before(arr.shape[0], self.periods, arr.device), torch.nan, out)


class ROC(SISOTransform):
    """Rate of change."""

    def __init__(self, periods: int, input_col: str = "close"):
        super().__init__(input_col, f"roc{periods}")
        self.periods = periods

    def _compute(self, x):
        return K.roc(self._prepare_input(x), self.periods)


class PctChange(SISOTransform):
    """Lagged percent change."""

    def __init__(self, window: int, input_col: str = "close"):
        super().__init__(input_col, f"pctc{window}")
        self.window = window  # kept for the config (ROADMAP R12)
        self.periods = window

    def _compute(self, x):
        return K.pct_change(self._prepare_input(x), self.periods)


class RSIWilder(SISOTransform):
    """Wilder RSI."""

    def __init__(self, window: int = 14, input_col: str = "close"):
        super().__init__(input_col, f"rsiw{window}")
        self.window = window

    def _compute(self, x):
        return K.rsi_wilder(self._prepare_input(x), self.window)


class StochK(MISOTransform):
    """Stochastic %K. Inputs [high, low, close]."""

    def __init__(self, length: int = 14, input_cols=None):
        if input_cols is None:
            input_cols = ["high", "low", "close"]
        super().__init__(input_cols, f"stochk{length}")
        self.length = length

    def _compute(self, x):
        d = self._prepare_input(x)
        # the reference passes (high, low, close) into stoch_k(close, low, high)
        # positionally: 'high' fills the close slot
        return K.stoch_k(d[self.requires[0]], d[self.requires[1]], d[self.requires[2]],
                         self.length)


class EWMST(SISOTransform):
    """Time-decay EWM standard deviation."""

    def __init__(self, half_life: datetime.timedelta, input_col: str = "y"):
        half_life_sec = half_life.total_seconds()
        super().__init__(input_col, f"ewms{half_life_sec}s")
        self.half_life = half_life  # kept for the config
        self.half_life_sec = half_life_sec

    def _compute(self, x):
        return K.ewmst(self._get_timestamps(x), self._prepare_input(x), self.half_life_sec)


class ZScore(SISOTransform):
    """Rolling z-score."""

    def __init__(self, window: int, input_col: str, ddof: int = 0):
        super().__init__(input_col, f"z{window}")
        self.window = window
        self.ddof = ddof

    def _compute(self, x):
        return K.comp_zscore(self._prepare_input(x), self.window, self.ddof)


class BurstRatio(SISOTransform):
    """x / rolling median."""

    def __init__(self, window: int, input_col: str):
        super().__init__(input_col, f"burst{window}")
        self.window = window

    def _compute(self, x):
        return K.comp_burst_ratio(self._prepare_input(x), self.window)


class VWAPDistance(MISOTransform):
    """Price distance from the rolling VWAP."""

    def __init__(self, periods: int, is_log: bool = False, input_cols=None):
        if input_cols is None:
            input_cols = ["close", "volume"]
        super().__init__(input_cols, f"vwapd{periods}")
        self.periods = periods
        self.is_log = is_log

    def _compute(self, x):
        d = self._prepare_input(x)
        return K.vwap_distance(d[self.requires[0]], d[self.requires[1]], self.periods,
                               self.is_log)


class TimeCues(SIMOTransform):
    """Cyclical time-of-day and day-of-week cues and session flags."""

    def __init__(self, input_col: str = "close"):
        produces = ["sin_td", "cos_td", "sin_dw", "cos_dw", "asia", "eu",
                    "us", "sess_x", "top_hr"]
        super().__init__(input_col, produces)

    def _compute(self, x):
        return self._prepare_output(K.time_cues(self._get_timestamps(x)))

    @property
    def output_name(self):
        return self.produces


class RealizedVolatility(SISOTransform):
    """Rolling realized volatility."""

    def __init__(self, window: int, is_sample=False, input_col: str = "ret"):
        super().__init__(input_col, f"rv{window}")
        self.window = window
        self.is_sample = is_sample

    def _compute(self, x):
        return K.realized_vol(self._prepare_input(x), self.window, self.is_sample)


class BollingerPercentB(SISOTransform):
    """Bollinger %B."""

    def __init__(self, window: int, num_std: float = 2.0, input_col: str = "close"):
        super().__init__(input_col, f"bollb{window}")
        self.window = window
        self.num_std = num_std

    def _compute(self, x):
        return K.bollinger_percent_b(self._prepare_input(x), self.window, self.num_std)


class ParkinsonRange(MISOTransform):
    """ln(h/l)^2 / 4 ln 2. Inputs [high, low]."""

    def __init__(self, input_cols=None):
        if input_cols is None:
            input_cols = ["high", "low"]
        super().__init__(input_cols, "parkrange")

    def _compute(self, x):
        d = self._prepare_input(x)
        return K.parkinson_range(d[self.requires[0]], d[self.requires[1]])


class SMA(SISOTransform):
    """Simple moving average."""

    def __init__(self, window: int, input_col: str = "x"):
        super().__init__(input_col, f"sma{window}")
        self.window = window

    def _compute(self, x):
        return K.sma(self._prepare_input(x), self.window)


class EWMA(SISOTransform):
    """Exponentially weighted moving average."""

    def __init__(self, span: int, input_col: str = None):
        super().__init__(input_col, f"ewma{span}")
        self.span = span

    def _compute(self, x):
        return K.ewma(self._prepare_input(x), self.span)


class FlowAcceleration(SISOTransform):
    """log(recent / past volume-sum ratio)."""

    def __init__(self, window: int, recent_periods, input_col: str = "volume"):
        super().__init__(input_col, f"flowacc_{window}_{recent_periods}")
        self.window = window
        self.recent_periods = recent_periods

    def _compute(self, x):
        return K.comp_flow_acceleration(self._prepare_input(x), self.window,
                                        self.recent_periods)


class CUSUMTest(SIMOTransform):
    """CSW structural-break score, flag and age features."""

    def __init__(self, window_size: int = 50, warmup_period: int = 30,
                 max_age: int = 144, input_col: str = "close"):
        base_up = f"cumote_up{window_size}"
        base_down = f"cumote_down{window_size}"
        produces = [
            f"{base_up}_score", f"{base_down}_score",
            f"{base_up}_flag", f"{base_down}_flag",
            f"{base_up}_age", f"{base_down}_age",
        ]
        super().__init__(input_col, produces)
        self.window_size = window_size
        self.warmup_period = warmup_period
        self.max_age = max_age

    def _age(self, flag: torch.Tensor) -> torch.Tensor:
        """Bars since the last flag (``groupby(cumsum(flag)).cumcount()``: the
        bar index before the first flag), clipped to ``max_age``, as uint8."""
        idx = torch.arange(flag.shape[0], device=flag.device)
        last = torch.cummax(torch.where(flag, idx, 0), 0).values
        return torch.clamp(idx - last, 0, self.max_age).to(torch.uint8)

    def _compute(self, x):
        snt_up, snt_down, cv_up, cv_down = K.cusum_test_rolling(
            self._prepare_input(x), self.window_size, self.warmup_period)
        break_up, break_down = snt_up - cv_up, snt_down - cv_down
        flag_up, flag_down = break_up > 0, break_down > 0
        return self._prepare_output((
            torch.clamp(break_up, -10, 10), torch.clamp(break_down, -10, 10),
            flag_up, flag_down, self._age(flag_up), self._age(flag_down)))

    @property
    def output_name(self):
        return self.produces


class ATR(MISOTransform):
    """Average True Range. Inputs [high, low, close]."""

    def __init__(self, window: int = 14, ema_based: bool = False,
                 normalize: bool = False, input_cols=None):
        if input_cols is None:
            input_cols = ["high", "low", "close"]
        output_name = f"atr{window}"
        if ema_based:
            output_name += "_ema"
        if normalize:
            output_name += "_norm"
        super().__init__(input_cols, output_name)
        self.window = window
        self.ema_based = ema_based
        self.normalize = normalize

    def _compute(self, x):
        d = self._prepare_input(x)
        return K.atr(d[self.requires[0]], d[self.requires[1]], d[self.requires[2]],
                     self.window, self.ema_based, self.normalize)


class PriceVolumeCorrelation(MISOTransform):
    """Rolling correlation of returns and volume."""

    def __init__(self, window: int = 8, input_cols=None):
        if input_cols is None:
            input_cols = ["close", "volume"]
        super().__init__(input_cols, f"corr_pv_{window}")
        self.window = window

    def _compute(self, x):
        d = self._prepare_input(x)
        return K.rolling_price_volume_correlation(d[self.requires[0]], d[self.requires[1]],
                                                  self.window)


class VPIN(MISOTransform):
    """Volume-synchronized probability of informed trading."""

    def __init__(self, window: int = 32, input_cols=None):
        if input_cols is None:
            input_cols = ["volume_buy", "volume_sell"]
        super().__init__(input_cols, f"vpin_{window}")
        self.window = window

    def _compute(self, x):
        d = self._prepare_input(x)
        return K.vpin(d[self.requires[0]], d[self.requires[1]], self.window)


class VarianceRatio14(SISOTransform):
    """var(1-bar return) / (var(4-bar return) / 4)."""

    def __init__(self, window: int = 32, input_col: str = "close",
                 ret_type: str = "log", ddof: int = 0):
        super().__init__(input_col, f"var_ratio_1_4_{window}")
        self.window = window
        self.ret_type = ret_type
        self.ddof = ddof

    def _compute(self, x):
        return K.variance_ratio_1_4(self._prepare_input(x), self.window, self.ddof,
                                    self.ret_type)


class KurtosisTransform(SISOTransform):
    """Rolling excess (Fisher) kurtosis from the window's moments, NaNs left
    out."""

    def __init__(self, window: int = 32, input_col: str = "ret1"):
        super().__init__(input_col, f"kurt_{window}")
        self.window = window

    def _compute(self, x):
        arr = _f64(self._prepare_input(x))
        w = self.window
        valid = ~torch.isnan(arr)
        az = torch.where(valid, arr, 0.0)
        cnt = roll_sum(valid.to(_F64), w)
        m1 = roll_sum(az, w) / cnt
        m2 = roll_sum(az * az, w) / cnt - m1 ** 2
        m3 = roll_sum(az ** 3, w) / cnt - 3 * m1 * m2 - m1 ** 3
        m4 = (roll_sum(az ** 4, w) / cnt - 4 * m1 * m3 - 6 * m1 ** 2 * m2 - m1 ** 4)
        kurt = torch.where(m2 > 0, m4 / (m2 * m2) - 3.0, torch.nan)
        return warmup_nan(torch.where(cnt > 0, kurt, torch.nan), w)


class TrendSlope(SISOTransform):
    """Rolling OLS slope of ln(close) against 0..w-1, in degrees (closed form
    over window sums)."""

    def __init__(self, window: int = 24, input_col: str = "close"):
        super().__init__(input_col, f"trend_slope_{window}")
        self.window = window

    def _compute(self, x):
        y = torch.log(_f64(self._prepare_input(x)))
        w = self.window
        n = y.shape[0]
        j = torch.arange(n, dtype=_F64, device=y.device)
        s0 = roll_sum(y, w)
        s1 = roll_sum(j * y, w)
        sum_k_y = s1 - (j - w + 1) * s0
        kbar = (w - 1) / 2.0
        denom = w * (w * w - 1) / 12.0
        slope = (sum_k_y - kbar * s0) / denom
        out = torch.atan(slope) * (180.0 / math.pi)
        return warmup_nan(torch.where(torch.isnan(s0), torch.nan, out), w)


class ADX(MISOTransform):
    """Average Directional Index."""

    def __init__(self, length: int = 14, input_cols=None):
        if input_cols is None:
            input_cols = ["high", "low", "close"]
        super().__init__(input_cols, f"adx_{length}")
        self.length = length

    def _compute(self, x):
        d = self._prepare_input(x)
        return K.adx(d[self.requires[0]], d[self.requires[1]], d[self.requires[2]],
                     self.length)


class MeanReversionZScore(SISOTransform):
    """(close - SMA) / rolling std (ddof 1). The variance ``(s2 - w mean^2) /
    (w - 1)`` cancels most of its digits on a price level, so its divisions
    are true divisions on every device: PyTorch's CUDA division by a Python
    number multiplies by the number's reciprocal, one rounding more."""

    def __init__(self, window: int = 48, input_col: str = "close"):
        super().__init__(input_col, f"mr_z_{window}")
        self.window = window

    def _compute(self, x):
        arr = _f64(self._prepare_input(x))
        w = self.window
        s = roll_sum(arr, w)
        s2 = roll_sum(arr * arr, w)
        mean = s / arr.new_tensor(float(w))
        var = (s2 - w * mean * mean) / arr.new_tensor(float(w - 1))
        std = torch.sqrt(torch.clamp(var, min=0.0))
        return warmup_nan((arr - mean) / std, w)


def _days(ts: torch.Tensor):
    """UTC day numbers of sorted int64 ns timestamps: each bar's day index
    among the days that hold a bar, the first bar of each such day, and the
    bars' positions within their day."""
    day = torch.div(ts, _DAY_NS, rounding_mode="floor")
    _, inv, counts = torch.unique_consecutive(day, return_inverse=True, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(ts.shape[0], device=ts.device) - first[inv]
    return inv, first, counts, pos


def _first_last_valid(v: torch.Tensor, inv: torch.Tensor, n_days: int):
    """Per day, the index of the first and of the last non-NaN value (-1:
    none), as ``resample("D").first()`` and ``.last()`` pick them."""
    n = v.shape[0]
    idx = torch.arange(n, device=v.device)
    ok = ~torch.isnan(v)
    first = torch.full((n_days,), n, device=v.device).scatter_reduce(
        0, inv[ok], idx[ok], "amin")
    last = torch.full((n_days,), -1, device=v.device).scatter_reduce(
        0, inv[ok], idx[ok], "amax")
    return torch.where(first < n, first, -1), last


class DailyGap(SISOTransform):
    """Overnight gap, set at the bar stamped exactly at a UTC midnight:
    ``(first value of the day - last value of the day's shifted series) /
    that last value``, the pandas reference's ``shift(1).resample("D").last()``
    included (the day's second-to-last value, or the day before's last for a
    one-bar day). The bars are sorted by time."""

    def __init__(self, input_col: str = "close"):
        super().__init__(input_col, "daily_gap")

    def _compute(self, x):
        v = _f64(self._prepare_input(x))
        ts = self._get_timestamps(x)
        n = v.shape[0]
        out = torch.full_like(v, torch.nan)
        if n == 0:
            return out
        inv, _, counts, _ = _days(ts)
        nd = counts.shape[0]
        shifted = torch.cat([v.new_full((1,), torch.nan), v[:-1]])
        first, _ = _first_last_valid(v, inv, nd)
        _, prev = _first_last_valid(shifted, inv, nd)
        ok = (first >= 0) & (prev >= 0)
        a = v[first.clamp(min=0)]
        b = shifted[prev.clamp(min=0)]
        gap = torch.where(ok, (a - b) / b, torch.nan)[inv]
        at_midnight = torch.remainder(ts, _DAY_NS) == 0
        return torch.where(at_midnight & ~torch.isnan(gap), gap, out)


class ORBBreak(MIMOTransform):
    """Opening-range breakout: on each UTC day whose first bar falls in its
    first minute and that holds at least 4 bars, the later bars whose close
    is above the first 4 bars' highest high (``orb_long``) or below their
    lowest low (``orb_short``), NaNs left out of the range. The bars are
    sorted by time."""

    def __init__(self, input_cols=None):
        if input_cols is None:
            input_cols = ["high", "low", "close"]
        super().__init__(input_cols, ["orb_long", "orb_short"])

    def _compute(self, x):
        d = self._prepare_input(x)
        high, low, close = (_f64(d[c]) for c in self.requires)
        ts = self._get_timestamps(x)
        n = close.shape[0]
        if n == 0:
            empty = torch.zeros(0, dtype=torch.bool, device=close.device)
            return empty, empty.clone()
        inv, first, counts, pos = _days(ts)
        opening = (torch.remainder(ts[first], _DAY_NS) < 60 * 10**9) & (counts >= 4)
        rows = (first[:, None] + torch.arange(4, device=ts.device)[None, :]).clamp(max=n - 1)
        nan = torch.full(rows.shape, torch.nan, dtype=_F64, device=ts.device)
        in_day = torch.arange(4, device=ts.device)[None, :] < counts[:, None]
        hi_rows = torch.where(in_day, high[rows], nan)
        lo_rows = torch.where(in_day, low[rows], nan)
        or_high = torch.where(torch.isnan(hi_rows), -torch.inf, hi_rows).amax(1)
        or_high = torch.where(torch.isnan(hi_rows).all(1), torch.nan, or_high)
        or_low = torch.where(torch.isnan(lo_rows), torch.inf, lo_rows).amin(1)
        or_low = torch.where(torch.isnan(lo_rows).all(1), torch.nan, or_low)
        rest = opening[inv] & (pos >= 4)
        return self._prepare_output((rest & (close > or_high[inv]),
                                     rest & (close < or_low[inv])))

    @property
    def output_name(self):
        return self.produces


class BarRate(SISOTransform):
    """Bars per hour in a trailing time window."""

    def __init__(self, window: datetime.timedelta, input_col: str = "close"):
        window_sec = window.total_seconds()
        window_min = window_sec / 60.0
        output_name = "bars_per_hour" if window_min.is_integer() else f"rate_{window_min}m"
        super().__init__(input_col, output_name)
        self.out_name = output_name
        self.window = window  # kept for the config (ROADMAP R12)
        self.window_sec = window_sec

    def _compute(self, x):
        ts = self._get_timestamps(x)
        start = torch.searchsorted(ts, ts - int(self.window_sec * 1e9))
        count = torch.arange(ts.shape[0], device=ts.device) - start + 1
        return count.to(_F64) / self.window_sec * 3600.0

    @property
    def output_name(self):
        return self.out_name


class CandleShape(MIMOTransform):
    """Wick and body ratios and the VWAP drift."""

    def __init__(self, input_cols=None):
        if input_cols is None:
            input_cols = ["open", "high", "low", "close", "vwap"]
        super().__init__(input_cols,
                         ["wick_up_ratio", "wick_dn_ratio", "body_ratio", "vwap_drift"])

    def _compute(self, x):
        d = self._prepare_input(x)
        o, h, l, c, v = (_f64(d[col]) for col in self.requires)
        rng = h - l + 1e-12
        max_oc, min_oc = torch.maximum(o, c), torch.minimum(o, c)
        return self._prepare_output(((h - max_oc) / rng, (min_oc - l) / rng,
                                     torch.abs(c - o) / rng, (v - o) / o))

    @property
    def output_name(self):
        return self.produces


class HurstExponent(SISOTransform):
    """Rolling Hurst exponent by the aggregated-variance method: the k-lag
    differences of the window's cumulative sum are the rolling k-sums of the
    returns, so each tau_k is a window moment."""

    _LAGS = (1, 2, 4, 8)

    def __init__(self, window: int = 24, input_col: str = "ret1"):
        super().__init__(input_col, f"hurst{window}")
        self.window = window

    def _compute(self, x):
        r = _f64(self._prepare_input(x))
        w = self.window
        lags = [k for k in self._LAGS if k < w]
        log_taus = []
        for k in lags:
            d = roll_sum(r, k)
            cntk = float(w - k)
            s1 = roll_sum(d, w - k)
            s2 = roll_sum(d * d, w - k)
            var = s2 / cntk - (s1 / cntk) ** 2
            log_taus.append(torch.log(torch.sqrt(torch.clamp(var, min=0.0))))
        lx = torch.log(torch.tensor(lags, dtype=_F64, device=r.device))
        ly = torch.stack(log_taus, 0)
        lxm = lx.mean()
        slope = ((lx[:, None] - lxm) * ly).sum(0) / ((lx - lxm) ** 2).sum()
        return warmup_nan(torch.where(torch.isfinite(slope), slope, torch.nan), w)


class ApproximateEntropy(SISOTransform):
    """Rolling approximate entropy (Pincus; Chebyshev distance, self-matches
    counted, tolerance ``tolerance * std`` of the window), from the windows'
    distance matrices in batches of bounded size."""

    _BATCH_CELLS = 1 << 22

    def __init__(self, window: int = 24, m: int = 2, tolerance: float = 0.2,
                 input_col: str = "ret1"):
        super().__init__(input_col, f"apen{window}")
        self.window = window
        self.m = m
        self.tolerance = tolerance

    def _phi(self, win, r, mm):
        nvec = self.window - mm + 1
        idx = torch.arange(nvec, device=win.device)[:, None] + \
            torch.arange(mm, device=win.device)[None, :]
        emb = win[:, idx]                                     # (b, nvec, mm)
        dist = (emb[:, :, None, :] - emb[:, None, :, :]).abs().amax(-1)
        cnt = (dist <= r[:, None, None]).sum(2).to(_F64)
        return torch.log(cnt / nvec).mean(1)

    def _compute(self, x):
        arr = _f64(self._prepare_input(x))
        w, n = self.window, arr.shape[0]
        wins = sliding_windows(arr, w)
        out = torch.empty_like(arr)
        batch = max(1, self._BATCH_CELLS // (w * w))
        for b0 in range(0, n, batch):
            win = wins[b0:b0 + batch]
            mean = win.mean(1, keepdim=True)
            r = self.tolerance * torch.sqrt(((win - mean) ** 2).mean(1))
            out[b0:b0 + batch] = self._phi(win, r, self.m) - self._phi(win, r, self.m + 1)
        return warmup_nan(out, w)


class BarDurationEWMA(SISOTransform):
    """EWMA of the inter-bar durations in seconds (NaN at the first bar)."""

    def __init__(self, span: int = 20, input_col: str = "close"):
        self.out_name = f"dur_ewma{span}"
        super().__init__(input_col, self.out_name)
        self.span = span

    def _compute(self, x):
        ts = self._get_timestamps(x)
        out = torch.full((ts.shape[0],), torch.nan, dtype=_F64, device=ts.device)
        if ts.shape[0] > 1:
            out[1:] = K.ewma(torch.diff(ts).to(_F64) / 1e9, self.span)
        return out

    @property
    def output_name(self):
        return self.out_name


class BarDuration(SISOTransform):
    """Duration in seconds over ``periods`` bars."""

    def __init__(self, periods=1, input_col: str = "close"):
        self.out_name = f"dur_{periods}bar"
        self.periods = periods
        super().__init__(input_col, self.out_name)

    def _compute(self, x):
        ts = self._get_timestamps(x)
        out = (ts - torch.roll(ts, self.periods)).to(_F64) / 1e9
        return torch.where(_before(ts.shape[0], self.periods, ts.device), torch.nan, out)

    @property
    def output_name(self):
        return self.out_name


class BiPowerVariation(SISOTransform):
    """Jump-robust bi-power variation."""

    def __init__(self, window: int = 12, input_col: str = "ret1"):
        super().__init__(input_col, f"bv_{window}")
        self.window = window
        self.mu1_inv_sq = (np.pi / 2) ** 0.5

    def _compute(self, x):
        r = torch.abs(_f64(self._prepare_input(x)))
        prod = r * torch.cat([r.new_full((1,), torch.nan), r[:-1]])
        return warmup_nan(self.mu1_inv_sq * roll_sum(prod, self.window), self.window + 1)


class DirRunLen(SISOTransform):
    """Length of the current run of same-sign returns (int8). The
    reference's quirks stay: 0 at index 0, index 1 never starts a change
    against itself, a zero return is 0."""

    def __init__(self, input_col: str = "ret1"):
        super().__init__(input_col, "dir_run_len")

    def _compute(self, x):
        arr = _f64(self._prepare_input(x))
        n = arr.shape[0]
        if n == 0:
            return torch.zeros(0, dtype=torch.int8, device=arr.device)
        sign = torch.where(torch.isnan(arr), torch.nan, torch.sign(arr))   # jnp.sign keeps NaN
        idx = torch.arange(n, device=arr.device)
        prev = torch.roll(sign, 1)
        if n > 1:
            prev[1] = sign[1]
        change = (sign != prev) | (idx <= 1)
        start = torch.cummax(torch.where(change, idx, 0), 0).values
        run = torch.where(sign != 0, idx - start + 1, 0)
        run[0] = 0
        return run.to(torch.int8)


def _on_device(y, like: torch.Tensor) -> torch.Tensor:
    """A callable's result as a tensor on the frame's device; a scalar fills
    the frame's length."""
    if not torch.is_tensor(y):
        y = torch.from_numpy(np.array(y))
    y = y.to(like.device)
    return y.expand(like.shape[0]).clone() if y.dim() == 0 else y


class ExternalFunction(BaseTransform):
    """An external callable (an object or an import path) as a transform. It
    gets the input columns as tensors, or as numpy arrays with
    ``pass_numpy=True``; numpy results come back onto the frame's device."""

    def __init__(self, func: Union[str, Callable],
                 input_cols: Union[str, Sequence],
                 output_cols: Union[str, Sequence, None] = None, *,
                 args: Optional[Sequence[Any]] = None,
                 kwargs: Optional[dict] = None,
                 pass_numpy: bool = False):
        if isinstance(func, str):
            func_path = func
            func_obj = None
            func_name = func.split(".")[-1]
        else:
            module = getattr(func, "__module__", None)
            name = getattr(func, "__name__", None)
            func_name = name or "external"
            func_path = f"{module}.{name}" if module and name else None
            func_obj = func

        produces = output_cols if output_cols is not None else f"ext_{func_name}"
        super().__init__(input_cols, produces)
        self._callable = func_obj
        self.func_path = func_path
        self.args = list(args) if args is not None else []
        self.kwargs = dict(kwargs) if kwargs is not None else {}
        self.pass_numpy = pass_numpy
        self._is_external_function = True

    @property
    def output_name(self):
        if isinstance(self.produces, list) and len(self.produces) == 1:
            return self.produces[0]
        return self.produces

    def _validate_input(self, x):
        if not isinstance(x, dict):
            raise TypeError("Input must be a dict of tensors")
        missing = [c for c in self.requires if c not in x]
        if missing:
            raise ValueError(f"Missing required columns: {missing}")
        return True

    def _resolve_func(self) -> Callable:
        if self._callable is not None:
            return self._callable
        if not self.func_path:
            raise ValueError("ExternalFunction requires a callable or import path")
        module_name, attr = self.func_path.rsplit(".", 1)
        mod = __import__(module_name, fromlist=[attr])
        fn = getattr(mod, attr)
        if not callable(fn):
            raise TypeError(f"Imported object {self.func_path} is not callable")
        self._callable = fn
        return fn

    def __call__(self, x, *, device="cuda"):
        x = as_frame(x, device)
        self._validate_input(x)
        fn = self._resolve_func()
        like = x[self.requires[0]]
        inputs = [x[c].cpu().numpy() if self.pass_numpy else x[c] for c in self.requires]
        result = fn(*(inputs + list(self.args)), **self.kwargs)
        if isinstance(result, (tuple, list)):
            if not isinstance(self.produces, list) or len(result) != len(self.produces):
                raise ValueError(f"ExternalFunction returned {len(result)} outputs, but "
                                 f"produces={self.produces}")
            return tuple(_on_device(item, like) for item in result)
        return _on_device(result, like)
