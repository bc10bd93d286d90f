"""Bar builder kits: numpy trades in, dicts of tensors out.

Counterpart of ``finmlkit_tpu/bar/kit.py`` (``BarBuilderBase`` and the seven
kits). The JAX kits take a pandas ``TradesData`` and return DataFrames; the
card's host has no pandas, so these take the port's ``TradesData``
(``bar/data_model.py``, a dict of numpy columns) or its four columns as numpy
arrays, and every ``build_*`` method returns a dict of tensors on the kit's device,
one value per bar, with the bars' close timestamps under ``"timestamp"``
(the DataFrames' index).

A kit quantizes the trades on the host (``bar/quantize.py``) and copies them
to its device once. Where the prices sit on no tick grid (``quantize_trades``
returns None), it keeps them as float64 on the device instead
(``interop.from_floats``) and takes the JAX kits' float64 path: the products
of ``bar/aggregate.py``, the exact float64 volume and dollar walks of
``bar/indexers.py`` (kernel D) and the float64 footprint grid of
``bar/footprint.py``; the time, tick, CUSUM, imbalance and run indexers are
the same on both paths. The TPU's bucket padding of trades and bars (a
compile-cache workaround) and the ``FMKT_*`` environment switches (TPU
dispatch) do not cross: every kit runs the kernels of the port, or with
``plain=True`` their plain PyTorch versions (the reference the kernels are
held against). The median engine and the bar scan that ``FMKT_MEDIANS`` and
``FMKT_SCAN`` select in the JAX kits are the keyword arguments ``medians`` and
``scan`` here.
"""
import functools
from abc import ABC, abstractmethod

import numpy as np
import torch

from .. import interop
from ..ops import event_scan, float_walk, prefix_scan
from . import aggregate, indexers
from .data_model import TradesData
from .aggregate_q import bar_trade_size_features, per_bar_theta
from .footprint_q import bar_footprints
from .fused import bar_products_final, bar_scan, median_engine
from .quantize import quantize_trades
from .utils import comp_price_tick_size

__all__ = ["BarBuilderBase", "TimeBarKit", "TickBarKit", "VolumeBarKit",
           "DollarBarKit", "ImbalanceBarKit", "RunBarKit", "CUSUMBarKit"]

_OHLCV = ("open", "high", "low", "close", "volume", "trades",
          "median_trade_size", "vwap")


def _takes_trades(init):
    """Let a kit's ``__init__`` take a :class:`TradesData` as its first
    argument, in place of its four trade columns (``timestamps, prices,
    amounts, sides``), as the JAX kits take one (``kit.py:343``)."""
    @functools.wraps(init)
    def wrapped(self, *args, **kw):
        if args and isinstance(args[0], TradesData):
            d = args[0].data
            args = (d["timestamp"], d["price"], d["amount"], d.get("side"), *args[1:])
        init(self, *args, **kw)
    return wrapped


class BarBuilderBase(ABC):
    """Template for the kits (``kit.py:52-337``). Subclasses implement
    ``_comp_bar_close``; ``bar_close_indices`` and ``bar_close_timestamps``
    leave out the open anchor, as the reference does.

    ``timestamps`` int64 ns, ``prices`` float64, ``amounts`` float32 and
    ``sides`` int8 (+1 buy, -1 sell; None when unknown) are host arrays of
    one length; every kit also takes a :class:`TradesData` in their place
    (its ``data``). ``device`` is where the kit works ("cuda" unless the caller
    asks for the CPU); ``plain`` runs every kernel's plain version instead.

    ``medians`` names the bar products' median engine (``bar/fused.py
    median_engine``): "sort" (the default; exact for any amount), "rowsort"
    (the same sort), "hist" (kernel H) or "select" (kernel F's int32 fill),
    exact for nonnegative amounts, or "host" (a threaded ``nth_element`` in
    C++ on the host, ``native/``). ``scan`` names the bar
    scan: "rowtail" (the default) or "rowtail4" (both kernel B, as the JAX
    kits' two rowtail kernels compute one function) or "planes" (the
    running state of every trade, kernel V, gathered at the bars).
    An unknown name raises. Both name
    engines of the quantized path: on trades whose prices sit on no tick
    grid (the float64 path) they do not apply, and a value other than the
    default raises.
    """

    def __init__(self, timestamps, prices, amounts, sides=None, *,
                 device="cuda", plain=False, medians="sort", scan="rowtail"):
        ts = np.ascontiguousarray(timestamps, dtype=np.int64)
        px = np.ascontiguousarray(prices, dtype=np.float64)
        amt = np.ascontiguousarray(amounts, dtype=np.float32)
        if not (len(ts) == len(px) == len(amt)) or len(ts) == 0:
            raise ValueError("timestamps, prices and amounts must be non-empty "
                             "and of one length")
        if sides is not None and len(sides) != len(ts):
            raise ValueError("sides must have the trades' length")
        q = quantize_trades(px, amt)
        self._float = q is None
        if self._float and (medians != "sort" or scan != "rowtail"):
            raise ValueError(
                f"medians={medians!r} and scan={scan!r} name engines of the "
                "quantized path; these prices sit on no tick grid, and their "
                "float64 path takes neither")
        self.device = torch.device(device)
        self._has_sides = sides is not None
        side = np.zeros(len(ts), np.int8) if sides is None else sides
        if self._float:
            self.trades = interop.from_floats(px, None, side, amt, self.device,
                                              timestamps=ts)
        else:
            self.trades = interop.from_numpy(q, None, side, amt, self.device,
                                             timestamps=ts)
        self._prices_host = px
        self._prices = self.trades.prices
        self._ts_first, self._ts_last = int(ts[0]), int(ts[-1])
        self._plain = bool(plain)
        self._bar_scan = bar_scan(scan, plain=self._plain)
        self._medians = median_engine(medians, plain=self._plain)
        self._close_ts = None
        self._ci = None
        self._products = None

    # -- kernels or their plain versions -----------------------------------
    @property
    def _cumsum(self):
        return prefix_scan.fast_cumsum_plain if self._plain else prefix_scan.fast_cumsum

    @property
    def _cumsum_cols(self):
        return (prefix_scan.fast_cumsum_cols_plain if self._plain
                else prefix_scan.fast_cumsum_cols)

    def _event_scan(self, name: str):
        return getattr(event_scan, f"{name}_plain" if self._plain else name)

    def _walk(self, name: str):
        return getattr(float_walk, f"{name}_plain" if self._plain else name)

    def _copy_prices(self) -> None:
        """Copy the float64 prices to the device once, for the kits and builds
        that read them (CUSUM bars, dollar-weighted imbalance and run bars,
        footprints); the float form holds them already."""
        if self._prices is None:
            self._prices = torch.from_numpy(self._prices_host).to(self.device)

    # -- close indices -----------------------------------------------------
    @abstractmethod
    def _comp_bar_close(self):
        """Return (close_ts, close_indices), the open anchor included."""

    def _set_bar_close(self):
        if self._ci is None:
            self._close_ts, self._ci = self._comp_bar_close()

    @property
    def bar_close_indices(self) -> torch.Tensor:
        self._set_bar_close()
        return self._ci[1:]

    @property
    def bar_close_timestamps(self) -> torch.Tensor:
        self._set_bar_close()
        return self._close_ts[1:]

    def _require_sides(self):
        if not self._has_sides:
            raise ValueError("the trades have no sides")

    # -- products ----------------------------------------------------------
    def _bar_products(self):
        """``(ohlcv, directional)``: of the quantized path, both from one bar
        scan; of the float64 path, each from ``bar/aggregate.py`` when first
        asked for."""
        if self._products is None:
            self._set_bar_close()
            t = self.trades
            if self._float:
                self._products = [None, None]
            else:
                self._products = bar_products_final(
                    t.ticks, t.units, self._ci, t.sides, tick_size=t.tick_size,
                    amount_scale=t.amount_scale, amounts_f32=t.amounts,
                    scan=self._bar_scan, medians=self._medians)
        return self._products

    def _ohlcv(self) -> dict:
        products = self._bar_products()
        if products[0] is None:
            t = self.trades
            products[0] = aggregate.comp_bar_ohlcv(t.prices, t.amounts, self._ci,
                                                   cumsum=self._cumsum)
        return products[0]

    def _directional(self) -> dict:
        products = self._bar_products()
        if products[1] is None:
            t = self.trades
            products[1] = aggregate.comp_bar_directional_features(
                t.prices, t.amounts, self._ci, t.sides, cumsum=self._cumsum,
                cumsum_cols=self._cumsum_cols)
        return products[1]

    def build_ohlcv(self) -> dict:
        """open, high, low, close, volume, trades, median_trade_size and vwap
        of every bar (``kit.py:197-223``)."""
        ohlcv = self._ohlcv()
        return {"timestamp": self.bar_close_timestamps,
                **{k: ohlcv[k] for k in _OHLCV}}

    def build_directional_features(self) -> dict:
        """Order-flow splits and the in-bar imbalance extrema
        (``kit.py:225-244``)."""
        self._require_sides()
        return {"timestamp": self.bar_close_timestamps, **self._directional()}

    def build_trade_size_features(self, theta, theta_mult: float = 5.0) -> dict:
        """Relative trade-size features (``kit.py:246-282``); ``theta`` is one
        typical trade size or one per bar."""
        self._set_bar_close()
        t = self.trades
        if not torch.is_tensor(theta):
            theta = torch.tensor(np.asarray(theta, np.float64))
        if self._float:
            feats = aggregate.comp_bar_trade_size_features(
                t.amounts, per_bar_theta(theta.to(self.device), self._ci),
                self._ci, theta_mult, cumsum=self._cumsum)
        else:
            feats = bar_trade_size_features(
                t.units, t.amounts, self._ci, theta.to(self.device),
                theta_mult=theta_mult, amount_scale=t.amount_scale,
                cumsum=self._cumsum, cumsum_cols=self._cumsum_cols)
        return {"timestamp": self.bar_close_timestamps, **feats}

    def build_footprints(self, price_tick_size=None,
                         imbalance_factor: float = 3.0) -> dict:
        """Dense footprints and their features (``kit.py:284-337``) on the
        grid of ``price_tick_size`` (default: the trades' tick as
        ``comp_price_tick_size`` infers it, as the JAX kit does). From the
        integer ticks where that grid refines the trades' tick and fits
        int32, else the float64 grid (``bar_footprints``)."""
        self._require_sides()
        ohlcv = self._ohlcv()
        t = self.trades
        if price_tick_size is None and self._float:
            price_tick_size = comp_price_tick_size(self._prices_host)
        self._copy_prices()
        fp = bar_footprints(t.ticks, t.amounts, self._ci, t.sides, ohlcv,
                            tick_size=t.tick_size,
                            price_tick_size=price_tick_size,
                            imbalance_factor=imbalance_factor,
                            prices=self._prices, cumsum=self._cumsum,
                            cumsum_cols=self._cumsum_cols)
        return {"timestamp": self.bar_close_timestamps, **fp}


class TimeBarKit(BarBuilderBase):
    """Fixed-interval time bars (``kit.py:340-352``); ``period`` in seconds
    (or a ``datetime.timedelta``)."""

    @_takes_trades
    def __init__(self, timestamps, prices, amounts, sides, period, **kw):
        super().__init__(timestamps, prices, amounts, sides, **kw)
        seconds = getattr(period, "total_seconds", None)
        self.interval = float(seconds() if seconds else period)

    def _comp_bar_close(self):
        return indexers.time_bar_indexer(self.trades.timestamps, self.interval,
                                         ts_first=self._ts_first,
                                         ts_last_i=self._ts_last)


class TickBarKit(BarBuilderBase):
    """Fixed tick-count bars (``kit.py:355-364``)."""

    @_takes_trades
    def __init__(self, timestamps, prices, amounts, sides, tick_count_thrs: int,
                 **kw):
        super().__init__(timestamps, prices, amounts, sides, **kw)
        self.tick_count_thrs = tick_count_thrs

    def _comp_bar_close(self):
        return indexers.tick_bar_indexer(self.trades.timestamps,
                                         self.tick_count_thrs)


class VolumeBarKit(BarBuilderBase):
    """Volume-threshold bars, reset-to-zero semantics (``kit.py:367-387``):
    on the integer amount units, or on trades off every tick grid with the
    exact float64 walk of kernel D (``indexers.volume_bar_indexer``)."""

    @_takes_trades
    def __init__(self, timestamps, prices, amounts, sides, volume_ths: float,
                 **kw):
        super().__init__(timestamps, prices, amounts, sides, **kw)
        self.volume_ths = volume_ths

    def _comp_bar_close(self):
        t = self.trades
        if self._float:
            return indexers.volume_bar_indexer(t.timestamps, t.amounts,
                                               self.volume_ths,
                                               walk=self._walk("volume_walk"))
        return indexers.volume_bar_indexer_q(
            t.timestamps, t.units, self.volume_ths, t.amount_scale,
            scan=self._event_scan("volume_scan"))


class DollarBarKit(BarBuilderBase):
    """Dollar-threshold bars, carry-remainder semantics (``kit.py:390-413``):
    on the integer dollar units, or on trades off every tick grid with the
    exact float64 walk of kernel D (``indexers.dollar_bar_indexer``)."""

    @_takes_trades
    def __init__(self, timestamps, prices, amounts, sides, dollar_thrs: float,
                 **kw):
        super().__init__(timestamps, prices, amounts, sides, **kw)
        self.dollar_thrs = dollar_thrs

    def _comp_bar_close(self):
        t = self.trades
        if self._float:
            return indexers.dollar_bar_indexer(t.timestamps, t.prices, t.amounts,
                                               self.dollar_thrs,
                                               walk=self._walk("dollar_walk"))
        return indexers.dollar_bar_indexer_q(
            t.timestamps, t.ticks, t.units, self.dollar_thrs, t.tick_size,
            t.amount_scale, cumsum=self._cumsum)


class _InfoBarKitBase(BarBuilderBase):
    """Imbalance and run bars (``kit.py:416-473``): ``mode`` "tick" (weights
    1), "volume" (the amounts) or "dollar" (price times amount, float64)."""

    _indexer = None  # set by the subclass

    @_takes_trades
    def __init__(self, timestamps, prices, amounts, sides, mode: str = "tick",
                 *, threshold=None, expected_ticks_init=None,
                 expected_rate_init=None, alpha_ticks: float = 0.0,
                 alpha_rate: float = 0.0, **kw):
        if mode not in ("tick", "volume", "dollar"):
            raise ValueError(f"mode must be tick/volume/dollar, got {mode!r}")
        if sides is None:
            raise ValueError("imbalance/run bars need trade sides")
        super().__init__(timestamps, prices, amounts, sides, **kw)
        self.mode = mode
        self.threshold = threshold
        self.expected_ticks_init = expected_ticks_init
        self.expected_rate_init = expected_rate_init
        self.alpha_ticks = alpha_ticks
        self.alpha_rate = alpha_rate
        if mode == "dollar":
            self._copy_prices()

    def _comp_bar_close(self):
        t = self.trades
        if self.mode == "tick":
            weights = None
        elif self.mode == "volume":
            weights = t.amounts
        else:
            weights = self._prices * t.amounts.to(torch.float64)
        return type(self)._indexer(
            t.timestamps, t.sides, weights, threshold=self.threshold,
            expected_ticks_init=self.expected_ticks_init,
            expected_rate_init=self.expected_rate_init,
            alpha_ticks=self.alpha_ticks, alpha_rate=self.alpha_rate,
            scan=self._event_scan("info_scan"))


class ImbalanceBarKit(_InfoBarKitBase):
    """Tick, volume or dollar imbalance bars."""
    _indexer = staticmethod(indexers.imbalance_bar_indexer)


class RunBarKit(_InfoBarKitBase):
    """Tick, volume or dollar run bars."""
    _indexer = staticmethod(indexers.run_bar_indexer)


class CUSUMBarKit(BarBuilderBase):
    """Adaptive-threshold CUSUM bars (``kit.py:476-511``), in float64.
    ``sigma`` holds one value per trade; NaNs are forward-filled."""

    @_takes_trades
    def __init__(self, timestamps, prices, amounts, sides, sigma,
                 sigma_floor: float = 5e-4, sigma_mult: float = 2.0, **kw):
        super().__init__(timestamps, prices, amounts, sides, **kw)
        if len(sigma) != self.trades.timestamps.shape[0]:
            raise ValueError("sigma must have one value per trade")
        self.lambda_mult = sigma_mult
        self.sigma_floor = sigma_floor
        sigma = sigma if torch.is_tensor(sigma) else torch.from_numpy(
            np.asarray(sigma, np.float64))
        self._sigma = sigma.to(self.device, torch.float64)
        self._copy_prices()

    def _comp_bar_close(self):
        close_ts, ci, filled = indexers.cusum_bar_indexer(
            self.trades.timestamps, self._prices, self._sigma,
            self.sigma_floor, self.lambda_mult,
            ffill=prefix_scan.fast_ffill_plain if self._plain else prefix_scan.fast_ffill,
            scan=self._event_scan("cusum_scan"))
        self._sigma = filled  # the reference fills the NaNs in place
        return close_ts, ci

    def get_sigma(self) -> torch.Tensor:
        """The filled sigma at every bar's close."""
        self._set_bar_close()
        return self._sigma[self.bar_close_indices]
