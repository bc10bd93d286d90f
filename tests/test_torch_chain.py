"""The port's chain against the JAX package's on the CPU: ``pipeline.py``
(bars -> medians -> features on the device, one readback) and the whole
``examples/quickstart.py`` flow (trades -> ``TradesData`` -> bars -> features
-> CUSUM events -> ``TBMLabel`` -> ``SampleWeights``).

The pipeline runs on ``tests/test_pipeline.py``'s ``_mk`` data with its five
features, the port with ``plain=True`` on CPU tensors and the JAX package in
interpret mode: ohlcv and directional columns exact, features within rtol
and atol 1e-12 with NaN at the same places, but for the z-score. On
``_mk``'s calm price level its window variance, ``E[x^2] - E[x]^2``, cancels
about 8 digits and XLA:CPU rounds it in a fused multiply-add that the port
does not use, so the two differ by about 1e-11: both are held to the exact
z-score (Decimal arithmetic) within ``4 eps cond (1 + |z|)``, ``cond =
E[x^2] / var``, as ``tests/test_torch_features.py`` holds the kernel.
Without ``amounts_f32`` the port's ``median_trade_size`` is NaN, where the JAX pipeline's is 0.0
(ROADMAP.md, Queue 3, R4). The quickstart runs at 60,000 trades (two hours;
at 20,000 trades, 40 minutes, no event outlives the leading-NaN trim and the
30-minute barrier, and the JAX chain itself raises) through both packages, each with its own transforms: bars, events and labels exact,
features within rtol 1e-12, uniqueness and attribution within rtol 1e-12 of
their prefix magnitude, the time decay within rtol 1e-12. The quickstart's
target is the EWM std of the price level, whose variance cancels about 7
digits: the two packages' targets part by up to ``8 eps cond`` relative
(``cond = x^2 / var``, measured about 1.5e-9), and the vertical-touch and
final weights, which scale with one over the target, are held within 2 and 8
times that part above rtol 1e-12 (the final weights also at the
attribution's prefix magnitude).
"""
import datetime
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu import pipeline as jpipeline
from finmlkit_tpu.bar import DollarBarKit as JDollarBarKit
from finmlkit_tpu.bar import TimeBarKit as JTimeBarKit
from finmlkit_tpu.bar import TradesData as JTradesData
from finmlkit_tpu.feature import Compose as JCompose
from finmlkit_tpu.feature import Feature as JFeature
from finmlkit_tpu.feature import FeatureKit as JFeatureKit
from finmlkit_tpu.feature import transforms as JT
from finmlkit_tpu.feature.fuse import build_fused_from_specs as jbuild_fused_from_specs
from finmlkit_tpu.label import SampleWeights as JSampleWeights
from finmlkit_tpu.label import TBMLabel as JTBMLabel
from finmlkit_tpu.sampling import cusum_filter as jcusum_filter
from finmlkit_tpu_torch import pipeline
from finmlkit_tpu_torch.bar import DollarBarKit, TimeBarKit, TradesData
from finmlkit_tpu_torch.feature import Compose, Feature, FeatureKit
from finmlkit_tpu_torch.feature import transforms as T
from finmlkit_tpu_torch.feature.fuse import build_fused_from_specs
from finmlkit_tpu_torch.label import SampleWeights, TBMLabel
from finmlkit_tpu_torch.sampling import cusum_filter
from finmlkit_tpu_torch.testing import assert_close, assert_exact, assert_window_close
from tests.test_pipeline import FEATS as JFEATS
from tests.test_pipeline import _mk

RTOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATS = [Feature(T.EWMA(20, "close")), Feature(T.RSIWilder(14, "close")),
         Feature(T.ATR(14)), Feature(T.Return(1, "close", is_log=True)),
         Feature(T.ZScore(50, "close"))]
BAR_COLS = ("open", "high", "low", "close", "volume", "vwap", "trades")
EWMST_CLOSE = "close_ewms1800.0s"      # the quickstart's target
EPS = np.finfo(np.float64).eps


@pytest.fixture(scope="module", autouse=True)
def _fresh_compiler_state():
    # as tests/test_pipeline.py: XLA:CPU has crashed compiling the JAX
    # pipeline's final-readback program after many earlier compilations
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def mk():
    price, amount, side, q, ci, ts = _mk()
    bar_ts = ts[np.clip(ci[1:], 0, len(ts) - 1)]
    t = {"ticks": torch.from_numpy(q.price_ticks.astype(np.int32)),
         "units": torch.from_numpy(q.amount_units.astype(np.int64)),
         "ci": torch.from_numpy(ci), "sides": torch.from_numpy(side),
         "amounts": torch.from_numpy(amount), "bar_ts": torch.from_numpy(bar_ts)}
    return q, ci, bar_ts, t


def _graph():
    return build_fused_from_specs(FEATS, dict.fromkeys(BAR_COLS), "timestamp")


def _port(mk, **kw):
    q, ci, _, t = mk
    return pipeline.bar_feature_pipeline_device(
        t["ticks"], t["units"], t["ci"], t["sides"], tick_size=q.tick_size,
        amount_scale=q.amount_scale, graph=_graph(), bar_ts=t["bar_ts"],
        plain=True, **kw)


@pytest.fixture(scope="module")
def jax_chain(mk):
    q, ci, bar_ts, _ = mk
    price, amount, side, *_ = _mk()
    n_bars = len(ci) - 1
    specs = {c: jax.ShapeDtypeStruct((n_bars,), np.float64) for c in BAR_COLS[:-1]}
    specs["trades"] = jax.ShapeDtypeStruct((n_bars,), np.int64)
    graph = jbuild_fused_from_specs(JFEATS, specs, jax.ShapeDtypeStruct((n_bars,), np.int64))
    return jpipeline.bar_feature_pipeline_device(
        jnp.asarray(q.price_ticks), jnp.asarray(q.amount_units), jnp.asarray(ci),
        jnp.asarray(side), tick_size=q.tick_size, amount_scale=q.amount_scale,
        graph=graph, bar_ts=jnp.asarray(bar_ts), amounts_f32=jnp.asarray(amount),
        ci_host=ci, interpret=True)


def _zscore_exact(x, w):
    """The exact z-score over each window of ``w`` ending at i, and its
    conditioning ``E[x^2] / var``."""
    from decimal import Decimal, localcontext
    exact, cond = np.full(len(x), np.nan), np.full(len(x), np.nan)
    with localcontext() as ctx:
        ctx.prec = 50
        for i in range(w - 1, len(x)):
            win = [Decimal(v) for v in x[i - w + 1:i + 1]]
            m = sum(win) / w
            m2 = sum(v * v for v in win) / w
            exact[i] = float((Decimal(x[i]) - m) / (m2 - m * m).sqrt())
            cond[i] = float(m2 / (m2 - m * m))
    return exact, cond


def test_pipeline_matches_jax(mk, jax_chain):
    got = _port(mk, amounts_f32=mk[3]["amounts"])
    jo, jd, jf = jax_chain
    o, d, f = got
    assert list(o) == list(jo) and list(d) == list(jd)
    for k in jo:
        assert_exact(o[k], np.asarray(jo[k]), f"ohlcv.{k}")
    for k in jd:
        assert_exact(d[k], np.asarray(jd[k]), f"directional.{k}")
    assert set(f) == set(jf) and len(f) >= len(FEATS)
    for k in jf:
        if k != "close_z50":
            assert_close(f[k], np.asarray(jf[k], np.float64), rtol=RTOL, atol=RTOL, what=k)
    exact, cond = _zscore_exact(o["close"], 50)
    bound = 4 * np.finfo(np.float64).eps * cond * (1.0 + np.abs(exact))
    for what, z in (("port", f["close_z50"]), ("jax", np.asarray(jf["close_z50"]))):
        assert np.array_equal(np.isnan(z), np.isnan(exact)), what
        assert np.all(np.abs(z - exact)[49:] <= bound[49:]), what


@pytest.mark.parametrize("scan", ["rowtail", "planes"])
def test_dispatch_then_drain_equals_one_call(mk, scan):
    q, ci, _, t = mk
    handles = pipeline.bar_feature_dispatch(
        t["ticks"], t["units"], t["ci"], t["sides"], tick_size=q.tick_size,
        amount_scale=q.amount_scale, graph=_graph(), bar_ts=t["bar_ts"],
        amounts_f32=t["amounts"], plain=True, scan=scan)
    assert handles.done is None
    got = pipeline.bar_feature_drain(handles)
    want = _port(mk, amounts_f32=t["amounts"])
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert isinstance(g[k], np.ndarray)
            assert_exact(g[k], w[k], k)


def test_without_medians_median_is_nan(mk):
    """R4: the JAX pipeline fills 0.0 where it computed no median
    (``finmlkit_tpu/pipeline.py:117-120``); the port's column is NaN."""
    o, _, _ = _port(mk)
    with_med, _, _ = _port(mk, amounts_f32=mk[3]["amounts"])
    assert np.isnan(o["median_trade_size"]).all()
    assert o["median_trade_size"].dtype == np.float64
    for k in with_med:
        if k != "median_trade_size":
            assert_exact(o[k], with_med[k], k)


def test_bar_cols_from_final(mk):
    q, ci, _, t = mk
    from finmlkit_tpu_torch.bar.fused import bar_products_final
    ohlcv, _ = bar_products_final(t["ticks"], t["units"], t["ci"], t["sides"],
                                  tick_size=q.tick_size, amount_scale=q.amount_scale,
                                  amounts_f32=t["amounts"])
    cols = pipeline.bar_cols_from_final(ohlcv)
    assert list(cols) == list(BAR_COLS)
    assert cols["volume"].dtype == torch.float64 and cols["trades"].dtype == torch.int64
    assert_exact(cols["volume"], ohlcv["volume"].double(), "volume")


# --- the quickstart, port against JAX ---------------------------------------

def _quickstart_synth(n):
    spec = importlib.util.spec_from_file_location(
        "quickstart", os.path.join(REPO, "examples", "quickstart.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synth(n=n)


def _jax_quickstart(ts, px, qty, ids, maker):
    """``examples/quickstart.py``'s main, step for step (footprints aside)."""
    trades = JTradesData(ts, px, qty, ids, is_buyer_maker=maker, preprocess=True, name="DEMO")
    tkit = JTimeBarKit(trades, pd.Timedelta(minutes=1))
    bars, direc = tkit.build_ohlcv(), tkit.build_directional_features()
    n_dollar = len(JDollarBarKit(trades, 2_000_000).build_ohlcv())
    df = bars.join(direc[["volume_buy", "volume_sell"]])
    kit = JFeatureKit([
        JFeature(JT.ReturnT(pd.Timedelta(minutes=1), is_log=True, input_col="close")),
        JFeature(JT.EWMA(20, "close")), JFeature(JT.RSIWilder(14, "close")),
        JFeature(JT.VPIN(16)),
        JFeature(JCompose(JT.Return(1, "close", is_log=True), JT.SMA(5, "close_ret1"))),
        JFeature(JT.EWMST(pd.Timedelta(minutes=30), "close")),
    ], retain=["close", "volume"])
    feats = kit.build(df, backend="jax", order="topo")
    events = jcusum_filter(feats["close"].values, np.array([0.001]))
    feats = feats.assign(tgt=feats["close_ewms1800.0s"])
    label_kit = JTBMLabel(feats.dropna(subset=["tgt"]), target_ret_col="tgt", min_ret=0.0,
                          horizontal_barriers=(1.0, 1.0),
                          vertical_barrier=pd.Timedelta(minutes=30))
    _, out = label_kit.compute_labels(trades)
    info = label_kit.compute_weights(trades)
    final = JSampleWeights.compute_final_weights(
        info["avg_uniqueness"], time_decay_intercept=0.5,
        return_attribution=info["return_attribution"],
        vertical_touch_weights=out["vertical_touch_weights"], labels=out["labels"])
    return dict(trades=trades, bars=bars, n_dollar=n_dollar, feats=feats,
                events=np.asarray(events), out=out, info=info, final=final)


def _port_quickstart(ts, px, qty, ids, maker):
    """The same flow through the port, on CPU tensors."""
    td = datetime.timedelta
    trades = TradesData(ts, px, qty, ids, is_buyer_maker=maker, preprocess=True, name="DEMO")
    tkit = TimeBarKit(trades, td(minutes=1), device="cpu")
    bars, direc = tkit.build_ohlcv(), tkit.build_directional_features()
    n_dollar = DollarBarKit(trades, 2_000_000, device="cpu").build_ohlcv()["close"].shape[0]
    frame = {**bars, "volume_buy": direc["volume_buy"], "volume_sell": direc["volume_sell"]}
    kit = FeatureKit([
        Feature(T.ReturnT(td(minutes=1), is_log=True, input_col="close")),
        Feature(T.EWMA(20, "close")), Feature(T.RSIWilder(14, "close")),
        Feature(T.VPIN(16)),
        Feature(Compose(T.Return(1, "close", is_log=True), T.SMA(5, "close_ret1"))),
        Feature(T.EWMST(td(minutes=30), "close")),
    ], retain=["close", "volume"])
    feats = kit.build(frame, order="topo", device="cpu")
    events = cusum_filter(feats["close"], [0.001])
    feats = {**feats, "tgt": feats["close_ewms1800.0s"]}
    keep = ~torch.isnan(feats["tgt"])
    label_kit = TBMLabel({k: v[keep] for k, v in feats.items()}, target_ret_col="tgt",
                         min_ret=0.0, horizontal_barriers=(1.0, 1.0),
                         vertical_barrier=td(minutes=30))
    _, out = label_kit.compute_labels(trades)
    info = label_kit.compute_weights(trades)
    final = SampleWeights.compute_final_weights(
        info["avg_uniqueness"], time_decay_intercept=0.5,
        return_attribution=info["return_attribution"],
        vertical_touch_weights=out["vertical_touch_weights"], labels=out["labels"])
    return dict(trades=trades, bars=bars, n_dollar=n_dollar, feats=feats, events=events,
                out=out, info=info, final=final)


def test_quickstart_chain_matches_jax():
    raw = _quickstart_synth(60_000)
    j, p = _jax_quickstart(*raw), _port_quickstart(*raw)
    for c in ("timestamp", "price", "amount", "side"):
        assert_exact(p["trades"].data[c], j["trades"].data[c].to_numpy(), c)
    for c in j["bars"].columns:
        assert_exact(p["bars"][c], j["bars"][c].to_numpy(), f"bars.{c}")
    assert p["n_dollar"] == j["n_dollar"] > 10
    for c in j["feats"].columns:
        if c not in (EWMST_CLOSE, "tgt"):
            assert_close(p["feats"][c], j["feats"][c].to_numpy(np.float64), rtol=RTOL,
                         atol=RTOL, what=f"features.{c}")
    # the EWM std of the price level: its variance cancels E[x^2] against
    # E[x]^2, so the two packages' roundings (XLA:CPU's fused multiply-adds)
    # part by eps * cond in relative terms, cond = x^2 / var (about 3e6)
    jt, pt = j["feats"][EWMST_CLOSE].to_numpy(), p["feats"][EWMST_CLOSE].numpy()
    assert np.array_equal(np.isnan(pt), np.isnan(jt))
    rel = np.nanmax(np.abs(pt - jt) / np.abs(jt))     # the targets' relative difference
    cond = raw[1].max() ** 2 / jt ** 2
    assert np.nanmax(np.abs(pt - jt) - 8 * EPS * cond * np.abs(jt)) <= 0
    assert_exact(p["feats"]["tgt"], pt, "tgt")
    assert_exact(p["events"], j["events"].astype(np.int64), "events")
    jo, po = j["out"], p["out"]
    assert po["labels"].shape[0] == len(jo) > 5
    for c in ("event_idx", "touch_idx"):
        assert_exact(po[c], jo[c].to_numpy().astype(np.int64), c)
    assert_exact(po["labels"], jo["labels"].to_numpy().astype(np.int8), "labels")
    scale = float(np.abs(np.log(raw[1])).max())
    assert_window_close(po["returns"], jo["returns"].to_numpy(), scale, RTOL, "returns")
    n = len(p["trades"].data["price"])
    assert_window_close(p["info"]["avg_uniqueness"], j["info"]["avg_uniqueness"].to_numpy(),
                        n, RTOL, "uniqueness")
    assert_window_close(p["info"]["return_attribution"],
                        j["info"]["return_attribution"].to_numpy(), scale, RTOL,
                        "attribution")
    # the vertical-touch weights scale with 1 / target, the final weights with
    # them and their mean: the targets' difference carries through, twice at most
    # into each, twice again through the mean and the class sums
    assert_close(po["vertical_touch_weights"], jo["vertical_touch_weights"].to_numpy(),
                 rtol=RTOL + 2 * rel, what="vertical_touch_weights")
    jfin, pfin = j["final"], p["final"]
    assert list(pfin) == list(jfin.columns)
    assert_close(pfin["time_decay_weights"], jfin["time_decay_weights"].to_numpy(),
                 rtol=RTOL, what="time decay")
    # the attribution scaled to mean 1, and the weights, carry the window sums'
    # error at their prefix magnitude
    raw_j = j["info"]["return_attribution"].to_numpy()
    ra_scale = scale * len(raw_j) / raw_j.sum()
    ra_j = jfin["return_attribution"].to_numpy()
    assert_window_close(pfin["return_attribution"], ra_j, ra_scale, RTOL, "final.attribution")
    assert_exact(pfin["vertical_touch_weights"], po["vertical_touch_weights"], "vtw")
    w_j = jfin["weights"].to_numpy()
    w_scale = float(np.max(w_j / ra_j)) * ra_scale
    assert_window_close(pfin["weights"], w_j, w_scale, RTOL + 8 * rel, "final.weights")
