"""The bar kits of finmlkit_tpu_torch (dicts of tensors) against the JAX kits'
DataFrames and FootprintData on the CPU, column by column, on the trades of
``tests/conftest.generate_trades``.

The JAX kits run as the CPU gives them: bar products from ``aggregate_q``,
trade-size features from the native host pass (the float64 semantics), and
footprints from the ``_q`` path. Volume and dollar kits are held against the
integer rules the port implements, so the JAX side gets ``FMKT_INDEXER=
device``; the CUSUM kit is held against both the native host loop and the
device scan.

Tolerances: close indices, timestamps, OHLCV and the integer directional
columns exact. The four cumulative-imbalance extrema are float32 differences
of stream-wide prefixes in the port, as in the TPU kernel it ports, and exact
integers rounded once in ``aggregate_q``: within 2^-22 of the largest signed
volume (dollar) prefix of the stream, two float32 ulps of it (measured: at
most 1.24 half-ulps); against the JAX kit's fused path (``FMKT_FUSED=
interpret``) they are exact, whatever the median engine and bar scan
(``FMKT_MEDIANS`` and ``FMKT_SCAN`` on the JAX side, ``medians`` and ``scan``
on the port's).
Trade-size features within rtol 1e-6 of the float64 path, footprints within
the ``_q`` path's float32 rounding (``tests/test_torch_pipeline.py``).

On trades whose prices sit on no tick grid both kits take their float64 path
(``bar/aggregate.py``, the exact volume and dollar loops, the float64
footprint grid; the JAX volume and dollar kits take their native host loops,
``FMKT_INDEXER=auto``): close indices and timestamps exact, the products as
``testing.hold_float_path`` holds them (``tests/test_torch_aggregate.py``),
the trade-size features within rtol 1e-6 (the JAX kit's native host pass),
the footprints as ``tests/test_torch_footprint_f64.py`` holds them.
"""
import time

import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu import native
from finmlkit_tpu.bar import TradesData
from finmlkit_tpu.bar import kit as jkit
from finmlkit_tpu_torch.bar import fused, kit
from finmlkit_tpu_torch.testing import assert_close, assert_exact, hold_float_path
from tests.conftest import generate_trades
from tests.test_torch_footprint_f64 import _hold as hold_footprints
from tests.test_torch_pipeline import assert_footprints_match_q

N = 5000
EXTREMA = {"cum_volume_min": "volume", "cum_volume_max": "volume",
           "cum_dollars_min": "dollars", "cum_dollars_max": "dollars"}


@pytest.fixture(scope="module")
def native_library():
    """The JAX kits' float64 trade-size pass and CUSUM host loop run in
    ``finmlkit_tpu.native``, which the first process to need it compiles into
    the package directory. A process that looks while another one is still
    writing the file fails to load it, gives up on it for good, and its kits
    fall back to paths with other semantics (``pct_block`` off by 2.6e-2 on
    the tick bars). So look again until the other process's build is whole."""
    for _ in range(120):
        if native.lib() is not None:
            return
        native._TRIED = False
        time.sleep(0.5)
    pytest.fail("finmlkit_tpu's native library does not build or load")


@pytest.fixture(scope="module")
def trades():
    return generate_trades(n=N, seed=1)


def _sigma(n):
    sigma = np.full(n, 5e-4)
    sigma[:50] = np.nan
    sigma[200:220] = np.nan
    return sigma


def _kits(name, trades):
    """(JAX kit, port kit, FMKT_INDEXER for the JAX side) of one case."""
    ts, px, amt, side = trades
    td = TradesData(ts, px, amt, side=side)
    vol_thr = float(amt.astype(np.float64).sum()) / 150
    dol_thr = float((px * amt.astype(np.float64)).sum()) / 150
    info = dict(expected_ticks_init=50.0, expected_rate_init=0.3,
                alpha_ticks=0.1, alpha_rate=0.05)
    cases = {
        "time": (jkit.TimeBarKit, (td, pd.Timedelta(seconds=30)),
                 kit.TimeBarKit, (30.0,), "auto"),
        "tick": (jkit.TickBarKit, (td, 100), kit.TickBarKit, (100,), "auto"),
        "volume": (jkit.VolumeBarKit, (td, vol_thr), kit.VolumeBarKit,
                   (vol_thr,), "device"),
        "dollar": (jkit.DollarBarKit, (td, dol_thr), kit.DollarBarKit,
                   (dol_thr,), "device"),
        "cusum_host": (jkit.CUSUMBarKit, (td, _sigma(N), 1e-4, 2.0),
                       kit.CUSUMBarKit, (_sigma(N), 1e-4, 2.0), "auto"),
        "cusum_device": (jkit.CUSUMBarKit, (td, _sigma(N), 1e-4, 2.0),
                         kit.CUSUMBarKit, (_sigma(N), 1e-4, 2.0), "device"),
        "imbalance_tick": (jkit.ImbalanceBarKit, (td,), kit.ImbalanceBarKit,
                           (), "auto", dict(threshold=17.0)),
        "imbalance_volume_ema": (jkit.ImbalanceBarKit, (td, "volume"),
                                 kit.ImbalanceBarKit, ("volume",), "auto",
                                 dict(expected_ticks_init=50.0,
                                      expected_rate_init=0.03, alpha_ticks=0.1,
                                      alpha_rate=0.05)),
        "run_tick_ema": (jkit.RunBarKit, (td,), kit.RunBarKit, (), "auto", info),
        "run_dollar": (jkit.RunBarKit, (td, "dollar"), kit.RunBarKit,
                       ("dollar",), "auto", dict(threshold=300.0)),
    }
    jcls, jargs, pcls, pargs, backend, *kw = cases[name]
    kw = kw[0] if kw else {}
    return (lambda: jcls(*jargs, **kw),
            pcls(ts, px, amt, side, *pargs, device="cpu", **kw), backend)


CASES = ["time", "tick", "volume", "dollar", "cusum_host", "cusum_device",
         "imbalance_tick", "imbalance_volume_ema", "run_tick_ema", "run_dollar"]


def _index_ns(df):
    return df.index.values.astype("datetime64[ns]").view(np.int64)


@pytest.mark.parametrize("name", CASES)
def test_kit_matches_jax(trades, name, monkeypatch, native_library):
    make_jax, pk, backend = _kits(name, trades)
    monkeypatch.setenv("FMKT_INDEXER", backend)
    jk = make_jax()
    assert_exact(pk.bar_close_indices, np.asarray(jk.bar_close_indices), "ci")
    assert_exact(pk.bar_close_timestamps, np.asarray(jk.bar_close_timestamps),
                 "close_ts")
    n_bars = len(jk.bar_close_indices)
    assert n_bars > 10

    o, po = jk.build_ohlcv(), pk.build_ohlcv()
    assert_exact(po["timestamp"], _index_ns(o), "ohlcv index")
    assert list(po)[1:] == list(o.columns)
    for c in o.columns:
        assert_exact(po[c], o[c].values, f"ohlcv.{c}")

    d, pd_ = jk.build_directional_features(), pk.build_directional_features()
    assert_exact(pd_["timestamp"], _index_ns(d), "directional index")
    assert list(pd_)[1:] == list(d.columns)
    ts, px, amt, side = trades
    signed = side * amt.astype(np.float64)
    prefix = {"volume": np.abs(np.cumsum(signed)).max(),
              "dollars": np.abs(np.cumsum(signed * px)).max()}
    for c in d.columns:
        if c in EXTREMA:
            assert_close(pd_[c], d[c].values, rtol=0.0,
                         atol=2**-22 * prefix[EXTREMA[c]], what=f"directional.{c}")
        else:
            assert_exact(pd_[c], d[c].values, f"directional.{c}")

    theta = o["median_trade_size"].values
    t, pt = jk.build_trade_size_features(theta, 5.0), \
        pk.build_trade_size_features(theta, 5.0)
    assert_exact(pt["timestamp"], _index_ns(t), "trade size index")
    for c in t.columns:
        assert_close(pt[c], t[c].values, rtol=1e-6, what=f"trade size {c}")

    f, pf = jk.build_footprints(), pk.build_footprints()
    assert_exact(pf["timestamp"], np.asarray(f.bar_timestamps), "footprint ts")
    assert_footprints_match_q(pf, {k: getattr(f, k) for k in pf if k != "timestamp"})

    if name.startswith("cusum"):
        assert_exact(pk.get_sigma(), np.asarray(jk.get_sigma()), "get_sigma")


def test_kit_products_match_jax_fused_path(trades, monkeypatch):
    # the JAX kit's fused path (the Pallas bar scan in interpret mode) is the
    # one the port reproduces: every product column bit for bit
    monkeypatch.setenv("FMKT_FUSED", "interpret")
    make_jax, pk, _ = _kits("tick", trades)
    jk = make_jax()
    o, po = jk.build_ohlcv(), pk.build_ohlcv()
    d, pd_ = jk.build_directional_features(), pk.build_directional_features()
    for df, got in ((o, po), (d, pd_)):
        for c in df.columns:
            assert_exact(got[c], df[c].values, c)


def test_kit_checks_inputs(trades):
    ts, px, amt, side = trades
    # prices on no tick grid take the float64 path: the OHLCV of the JAX kit's
    # (its float64 fallback), with the sums within their prefix bound
    off = px + np.random.default_rng(0).random(N) * 1e-7
    fk = kit.TickBarKit(ts, off, amt, side, 100, device="cpu")
    assert fk.trades.ticks is None and fk.trades.prices is not None
    _hold_ohlcv(fk.build_ohlcv(), jkit.TickBarKit(TradesData(ts, off, amt, side=side),
                                                  100).build_ohlcv(), off, amt)
    pk = kit.TickBarKit(ts, px, amt, None, 100, device="cpu")
    assert pk.build_ohlcv()["close"].shape == (N // 100,)
    with pytest.raises(ValueError, match="sides"):
        pk.build_directional_features()
    with pytest.raises(ValueError, match="sides"):
        kit.ImbalanceBarKit(ts, px, amt, None, threshold=17.0, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        kit.RunBarKit(ts, px, amt, side, "ticks", threshold=17.0, device="cpu")
    with pytest.raises(ValueError, match="Theta"):
        kit.TickBarKit(ts, px, amt, side, 100, device="cpu") \
            .build_trade_size_features(np.ones(3))
    # the default device is the card: without one, the copy fails
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            kit.TickBarKit(ts, px, amt, side, 100)


@pytest.mark.parametrize("medians,scan", [("hist", "rowtail"), ("select", "rowtail"),
                                          ("sort", "planes")])
def test_kit_engines_match_jax_fused_path(trades, monkeypatch, medians, scan):
    # the JAX kit's fused path with the engine and scan chosen by its
    # environment switches (Pallas kernels in interpret mode) against the
    # port's kit with the same choice by keyword: every column bit for bit
    for key, value in (("FMKT_FUSED", "interpret"), ("FMKT_MEDIANS", medians),
                       ("FMKT_SCAN", scan)):
        monkeypatch.setenv(key, value)
    ts, px, amt, side = trades
    jk = jkit.TimeBarKit(TradesData(ts, px, amt, side=side), pd.Timedelta(seconds=30))
    pk = kit.TimeBarKit(ts, px, amt, side, 30.0, device="cpu", medians=medians,
                        scan=scan)
    o, po = jk.build_ohlcv(), pk.build_ohlcv()
    d, pd_ = jk.build_directional_features(), pk.build_directional_features()
    assert len(o) > 10
    for df, got in ((o, po), (d, pd_)):
        for c in df.columns:
            assert_exact(got[c], df[c].values, f"{medians}/{scan} {c}")


def test_kit_engine_and_scan_names_are_checked(trades):
    ts, px, amt, side = trades
    with pytest.raises(ValueError, match="median engine"):
        kit.TimeBarKit(ts, px, amt, side, 30.0, device="cpu", medians="nth_element")
    with pytest.raises(ValueError, match="bar scan"):
        kit.TimeBarKit(ts, px, amt, side, 30.0, device="cpu", scan="rows")
    pk = kit.TimeBarKit(ts, px, amt, side, 30.0, device="cpu")
    ref = pk.build_ohlcv()
    t = pk.trades
    with pytest.raises(ValueError, match="median engine"):
        fused.bar_products_final(t.ticks, t.units, pk._ci, t.sides,
                                 tick_size=t.tick_size, amount_scale=t.amount_scale,
                                 amounts_f32=t.amounts, medians="radix")
    # rowtail4 is kernel B as rowtail is; plain=True runs the plain engines;
    # "host" is the threaded nth_element of finmlkit_tpu_torch/native
    for kw in (dict(scan="rowtail4"), dict(medians="select", plain=True),
               dict(medians="hist", scan="planes", plain=True), dict(medians="host")):
        got = kit.TimeBarKit(ts, px, amt, side, 30.0, device="cpu", **kw).build_ohlcv()
        for c in ref:
            assert_exact(got[c], ref[c], f"{kw} {c}")


def _hold_ohlcv(got, want, px, amt):
    """The float64 path's OHLCV against the JAX kit's DataFrame
    (``testing.hold_float_path``)."""
    assert_exact(got["timestamp"], _index_ns(want), "ohlcv index")
    assert list(got)[1:] == list(want.columns)
    hold_float_path(got, {c: want[c].values for c in want.columns}, px, amt,
                    want["volume"].values, "ohlcv")


OFF_GRID_CASES = ["time", "tick", "volume", "dollar"]


@pytest.fixture(scope="module")
def off_grid(trades):
    ts, px, amt, side = trades
    return ts, px + np.random.default_rng(0).random(N) * 1e-7, amt, side


@pytest.mark.parametrize("name", OFF_GRID_CASES)
def test_off_grid_kit_matches_jax(off_grid, name, monkeypatch, native_library):
    make_jax, pk, _ = _kits(name, off_grid)
    monkeypatch.setenv("FMKT_INDEXER", "auto")     # the exact host loops
    jk = make_jax()
    assert jk._ticks is None and pk.trades.ticks is None
    assert_exact(pk.bar_close_indices, np.asarray(jk.bar_close_indices), "ci")
    assert_exact(pk.bar_close_timestamps, np.asarray(jk.bar_close_timestamps),
                 "close_ts")
    assert len(jk.bar_close_indices) > 10
    ts, px, amt, side = off_grid

    o, po = jk.build_ohlcv(), pk.build_ohlcv()
    _hold_ohlcv(po, o, px, amt)

    d, pd_ = jk.build_directional_features(), pk.build_directional_features()
    assert_exact(pd_["timestamp"], _index_ns(d), "directional index")
    # the JAX kit's float64 frame takes the jitted dict's sorted keys; the
    # port keeps the order of its quantized path
    assert set(pd_) - {"timestamp"} == set(d.columns)
    hold_float_path(pd_, {c: d[c].values for c in d.columns}, px, amt,
                    o["volume"].values, "directional")

    theta = o["median_trade_size"].values
    t, pt = jk.build_trade_size_features(theta, 5.0), \
        pk.build_trade_size_features(theta, 5.0)
    assert_exact(pt["timestamp"], _index_ns(t), "trade size index")
    for c in t.columns:
        assert_close(pt[c], t[c].values, rtol=1e-6, what=f"trade size {c}")

    f, pf = jk.build_footprints(0.01), pk.build_footprints(0.01)
    assert_exact(pf["timestamp"], np.asarray(f.bar_timestamps), "footprint ts")
    hold_footprints({k: v for k, v in pf.items() if k != "timestamp"},
                    {k: getattr(f, k) for k in pf if k != "timestamp"}, name)
    # the default tick of unrounded prices is about 1e-12: no grid of it fits
    with pytest.raises(ValueError, match="int32|coarser"):
        pk.build_footprints()


def test_off_grid_kit_plain_and_engine_names(off_grid):
    ts, px, amt, side = off_grid
    thr = float((px * amt.astype(np.float64)).sum()) / 150
    k = kit.DollarBarKit(ts, px, amt, side, thr, device="cpu")
    p = kit.DollarBarKit(ts, px, amt, side, thr, device="cpu", plain=True)
    assert_exact(k.bar_close_indices, p.bar_close_indices, "ci, plain")
    for a, b in ((k.build_ohlcv(), p.build_ohlcv()),
                 (k.build_directional_features(), p.build_directional_features())):
        for c in a:
            assert_exact(a[c], b[c], f"{c}, plain")
    # the quantized path's engines do not apply to the float64 path
    for kw in (dict(medians="hist"), dict(scan="planes"), dict(scan="rowtail4")):
        with pytest.raises(ValueError, match="no tick grid"):
            kit.TimeBarKit(ts, px, amt, side, 30.0, device="cpu", **kw)
