"""The feature framework of finmlkit_tpu_torch (``feature/base.py``,
``transforms.py``, ``kit.py``, ``utils.py``, ``fuse.py``; the plain path on
the CPU) against the JAX package's ``finmlkit_tpu.feature``.

Both sides get the same numpy columns: the port as a dict of tensors with
int64 ns timestamps under ``"timestamp"``, the JAX package as a DataFrame
with a ``DatetimeIndex`` of the same timestamps (``backend="jax"``; its
calendar transforms run their pandas tier there). Floats agree within
``rtol 1e-12, atol 1e-12`` with NaN positions equal, flags and integer
outputs exactly, dtypes equal (``tests/test_torch_features.py`` gives the
kernels' reasons). The mean-reversion z-score takes the raw-moment variance
of a price level, as the z-score does: XLA:CPU rounds it in one fused
multiply-add, so it is held to JAX at window 20 on a series that moves 1% a
bar, and to the exact value on a calm level by its conditioning. The
``Feature`` helpers replace pandas lambdas and are held to pandas within
``rtol 1e-10``: pandas adds rolling windows online and the port directly,
and its EWM and rolling std round in another order.
"""
import datetime
import json

import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu.feature import Compose as JCompose
from finmlkit_tpu.feature import Feature as JFeature
from finmlkit_tpu.feature import FeatureKit as JFeatureKit
from finmlkit_tpu.feature import transforms as JT
from finmlkit_tpu_torch.feature import Compose, Feature, FeatureKit
from finmlkit_tpu_torch.feature import fuse
from finmlkit_tpu_torch.feature import transforms as PT
from finmlkit_tpu_torch.testing import assert_close, assert_exact

RTOL = ATOL = 1e-12
N = 600
NAN_AT = (3, 40, 41, 300, 597)
T0 = 1_704_067_200 * 10**9      # 2024-01-01 00:00:00 UTC in ns
DAY = 86_400 * 10**9


def _cols(nans: bool, n: int = N, seed: int = 0) -> dict:
    r = np.random.default_rng(seed)
    close = 100.0 * np.exp(np.cumsum(r.normal(0.0, 1e-2, n)))
    high = close * (1.0 + np.abs(r.normal(0.0, 5e-3, n)))
    low = close * (1.0 - np.abs(r.normal(0.0, 5e-3, n)))
    volume = r.lognormal(2.0, 1.0, n)
    buy = volume * r.uniform(0.0, 1.0, n)
    c = dict(close=close, high=high, low=low, open=close * (1.0 + r.normal(0.0, 2e-3, n)),
             volume=volume, vwap=(high + low + close) / 3.0, volume_buy=buy,
             volume_sell=volume - buy, ret1=np.concatenate([[np.nan], np.diff(np.log(close))]))
    if nans:
        for key in ("close", "high", "low", "volume", "volume_buy", "ret1"):
            c[key][list(NAN_AT)] = np.nan
    ts = T0 + np.cumsum(r.integers(1, 120, n) * 10**9 + r.integers(0, 10**9, n))
    return c, ts.astype(np.int64)


def _frame(cols, ts) -> dict:
    f = {k: torch.from_numpy(np.array(v)) for k, v in cols.items()}
    f["timestamp"] = torch.from_numpy(np.array(ts, np.int64))
    return f


def _df(cols, ts) -> pd.DataFrame:
    return pd.DataFrame({k: np.array(v) for k, v in cols.items()},
                        index=pd.DatetimeIndex(np.array(ts, "datetime64[ns]")))


def _td(side, seconds):
    """A window: pandas' Timedelta for the JAX package, the standard
    library's timedelta for the port (which has no pandas)."""
    return pd.Timedelta(seconds=seconds) if side == "jax" else datetime.timedelta(seconds=seconds)


def _hold(got, want, what, rtol=RTOL, atol=ATOL):
    """Port (a tensor or a tuple) against JAX (a Series or a tuple)."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold(g, w, f"{what}[{i}]", rtol, atol)
        return
    assert torch.is_tensor(got), what
    w = np.asarray(want)
    g = got.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, (what, g.dtype, w.dtype, g.shape)
    if w.dtype.kind == "f":
        assert_close(g, w, rtol=rtol, atol=atol, what=what)
    else:
        assert_exact(g, w, what)


# name -> f(T, side): the same constructor call on both packages' transforms
SPECS = {
    "Identity": lambda T, s: T.Identity("close"),
    "Lag": lambda T, s: T.Lag(3, "close"),
    "ReturnT": lambda T, s: T.ReturnT(_td(s, 300), True, "close"),
    "Return": lambda T, s: T.Return(2, "close", is_log=True),
    "ROC": lambda T, s: T.ROC(10, "close"),
    "PctChange": lambda T, s: T.PctChange(5, "close"),
    "RSIWilder": lambda T, s: T.RSIWilder(14, "close"),
    "StochK": lambda T, s: T.StochK(14),
    "EWMST": lambda T, s: T.EWMST(_td(s, 600), "ret1"),
    "ZScore": lambda T, s: T.ZScore(20, "close"),
    "BurstRatio": lambda T, s: T.BurstRatio(10, "volume"),
    "VWAPDistance": lambda T, s: T.VWAPDistance(20, True),
    "TimeCues": lambda T, s: T.TimeCues("close"),
    "RealizedVolatility": lambda T, s: T.RealizedVolatility(30, input_col="ret1"),
    "BollingerPercentB": lambda T, s: T.BollingerPercentB(20, 2.0, "close"),
    "ParkinsonRange": lambda T, s: T.ParkinsonRange(),
    "SMA": lambda T, s: T.SMA(20, "close"),
    "EWMA": lambda T, s: T.EWMA(20, "close"),
    "FlowAcceleration": lambda T, s: T.FlowAcceleration(20, 5),
    "CUSUMTest": lambda T, s: T.CUSUMTest(),
    "ATR": lambda T, s: T.ATR(14),
    "PriceVolumeCorrelation": lambda T, s: T.PriceVolumeCorrelation(),
    "VPIN": lambda T, s: T.VPIN(),
    "VarianceRatio14": lambda T, s: T.VarianceRatio14(),
    "KurtosisTransform": lambda T, s: T.KurtosisTransform(),
    "TrendSlope": lambda T, s: T.TrendSlope(),
    "ADX": lambda T, s: T.ADX(),
    "MeanReversionZScore": lambda T, s: T.MeanReversionZScore(20),
    "DailyGap": lambda T, s: T.DailyGap(),
    "ORBBreak": lambda T, s: T.ORBBreak(),
    "BarRate": lambda T, s: T.BarRate(_td(s, 3600)),
    "CandleShape": lambda T, s: T.CandleShape(),
    "HurstExponent": lambda T, s: T.HurstExponent(),
    "ApproximateEntropy": lambda T, s: T.ApproximateEntropy(),
    "BarDurationEWMA": lambda T, s: T.BarDurationEWMA(),
    "BarDuration": lambda T, s: T.BarDuration(2),
    "BiPowerVariation": lambda T, s: T.BiPowerVariation(),
    "DirRunLen": lambda T, s: T.DirRunLen(),
    "ExternalFunction": lambda T, s: T.ExternalFunction("numpy.log1p", "volume",
                                                        pass_numpy=True),
}


def test_every_class_has_a_case():
    classes = {n for n, c in vars(PT).items()
               if isinstance(c, type) and c.__module__ == PT.__name__}
    assert classes == set(SPECS) and len(classes) == 39


@pytest.mark.parametrize("nans", [False, True], ids=["clean", "nans"])
@pytest.mark.parametrize("name", list(SPECS))
def test_transform_matches_jax(name, nans):
    cols, ts = _cols(nans)
    want = SPECS[name](JT, "jax")(_df(cols, ts), backend="jax")
    t = SPECS[name](PT, "port")
    got = t(_frame(cols, ts), device="cpu")
    _hold(got, want, name)
    assert t.output_name == SPECS[name](JT, "jax").output_name


def test_mean_reversion_zscore_on_a_calm_level_within_its_conditioning():
    """At its default window (48) on a calm price level the variance
    ``E[x^2] - E[x]^2`` cancels about 8 digits: the port and the JAX package
    are each within ``4 eps cond (1 + |z|)`` of the exact z-score (Decimal,
    50 digits), ``cond = E[x^2] / var``."""
    from decimal import Decimal, localcontext
    r = np.random.default_rng(0)
    n, w = 300, 48
    x = 107_000.0 * np.exp(np.cumsum(r.normal(0.0, 6e-4, n)))
    exact, cond = np.full(n, np.nan), np.full(n, np.nan)
    with localcontext() as ctx:
        ctx.prec = 50
        for i in range(w - 1, n):
            win = [Decimal(v) for v in x[i - w + 1:i + 1]]
            m = sum(win) / w
            m2 = sum(v * v for v in win) / w
            var = (m2 - m * m) * w / (w - 1)
            exact[i] = float((Decimal(x[i]) - m) / var.sqrt())
            cond[i] = float(m2 / (m2 - m * m))
    cols, ts = {"close": x}, T0 + np.arange(n, dtype=np.int64) * 60 * 10**9
    port = PT.MeanReversionZScore(w)(_frame(cols, ts), device="cpu").numpy()
    jax_ = np.asarray(JT.MeanReversionZScore(w)(_df(cols, ts), backend="jax"))
    ok = ~np.isnan(exact)
    bound = 4 * np.finfo(float).eps * cond[ok] * (1 + np.abs(exact[ok]))
    for what, got in (("port", port), ("jax", jax_)):
        assert np.isnan(got[~ok]).all()
        assert (np.abs(got[ok] - exact[ok]) <= bound).all(), what


# --- calendar transforms on multi-day bars ---------------------------------

def _calendar_ts():
    """Bars over nine UTC days: 15-minute bars from midnight; a day that
    starts at 00:00:30 (inside the first minute, not at midnight); a day
    that starts at 02:00; two empty days; a day of 3 bars from midnight; a
    day of one bar at midnight; bars at 00:00 exactly on days that also have
    NaN closes."""
    days = []
    d0 = T0 // DAY

    def day(k, offsets_min):
        return [(d0 + k) * DAY + int(m * 60e9) for m in offsets_min]
    days += day(0, np.arange(0, 1440, 15))
    days += day(1, 0.5 + np.arange(0, 1440, 15))
    days += day(2, 120 + np.arange(0, 1200, 15))
    days += day(5, [0, 15, 30])
    days += day(6, [0])
    days += day(7, np.arange(0, 1440, 15))
    days += day(8, np.arange(0, 600, 15))
    return np.asarray(days, np.int64)


@pytest.mark.parametrize("nans", [False, True], ids=["clean", "nans"])
@pytest.mark.parametrize("name", ["DailyGap", "ORBBreak", "TimeCues", "BarRate",
                                  "BarDuration", "BarDurationEWMA"])
def test_calendar_transforms_match_jax_on_edge_days(name, nans):
    ts = _calendar_ts()
    cols, _ = _cols(False, n=len(ts), seed=4)
    if nans:
        day7 = int(np.searchsorted(ts, (T0 // DAY + 7) * DAY))
        for key in ("close", "high", "low"):
            cols[key][[day7, day7 + 1, day7 + 5]] = np.nan   # the midnight bar and the range
    want = SPECS[name](JT, "jax")(_df(cols, ts), backend="jax")
    got = SPECS[name](PT, "port")(_frame(cols, ts), device="cpu")
    _hold(got, want, name)
    if name == "DailyGap" and not nans:
        assert int((~torch.isnan(got)).sum()) >= 4       # the midnight bars
    if name == "ORBBreak":
        assert bool(got[0].any() or got[1].any())


def test_time_transforms_need_timestamps():
    cols, _ = _cols(False)
    frame = {k: torch.from_numpy(v) for k, v in cols.items()}
    for name in ("ReturnT", "EWMST", "TimeCues", "BarRate", "DailyGap", "ORBBreak",
                 "BarDurationEWMA", "BarDuration"):
        with pytest.raises(ValueError, match="'timestamp'"):
            SPECS[name](PT, "port")(frame, device="cpu")


def test_missing_columns_raise_as_jax():
    cols, ts = _cols(False)
    frame, df = _frame(cols, ts), _df(cols, ts)
    del frame["close"]
    df = df.drop(columns=["close"])
    for t_jax, t_port in ((JT.SMA(5, "close"), PT.SMA(5, "close")),
                          (JT.ATR(14), PT.ATR(14)),
                          (JT.TimeCues("close"), PT.TimeCues("close")),
                          (JT.ORBBreak(), PT.ORBBreak()),
                          (JT.Identity("close"), PT.Identity("close")),
                          (JT.ExternalFunction(np.log, "close"),
                           PT.ExternalFunction(np.log, "close"))):
        with pytest.raises(ValueError) as e_jax:
            t_jax(df, backend="jax")
        with pytest.raises(ValueError) as e_port:
            t_port(frame, device="cpu")
        assert str(e_port.value) == str(e_jax.value)
    with pytest.raises(TypeError, match="dict of tensors"):
        PT.SMA(5, "close")(np.zeros(5), device="cpu")


# --- Feature operators and helpers -------------------------------------------

def _feature_cases(F, T):
    sma5, sma20 = F(T.SMA(5, "close")), F(T.SMA(20, "close"))
    ret = F(T.Return(1, "close"))
    return {
        "add": sma5 + sma20, "sub": sma5 - sma20, "mul": sma5 * sma20, "div": sma5 / sma20,
        "add_const": sma5 + 2, "sub_const": sma5 - 1.5, "mul_const": sma5 * 3,
        "div_const": sma5 / 4, "radd": 2 + sma5, "rsub": 100 - sma5, "rmul": 3 * sma5,
        "rdiv": 1 / ret, "abs": abs(ret), "abs_method": ret.abs(),
        "min": F.min(sma5, sma20), "max": F.max(sma5, sma20),
        "min_const": F.min(ret, 0.001), "max_const_left": F.max(0.0, ret),
        "clip": ret.clip(-0.005, 0.005), "clip_low": ret.clip(lower=0),
        "log": ret.log(), "log1p": ret.log1p(), "exp": ret.exp(), "square": ret.square(),
        "sqrt": ret.sqrt(), "rolling_mean": ret.rolling_mean(10),
        "ema": ret.ema(8), "ema_unadjusted": ret.ema(8, adjust=False),
        "ema_price": sma5.ema(30), "rolling_sum": ret.rolling_sum(7),
        "rolling_std": sma5.rolling_std(12), "lag": sma5.lag(3), "lead": sma5.lag(-2),
        "chain": ((sma5 - sma20) / sma20).abs().rolling_mean(5),
    }


FEATURE_CASES = list(_feature_cases(Feature, PT))


@pytest.mark.parametrize("nans", [False, True], ids=["clean", "nans"])
@pytest.mark.parametrize("case", FEATURE_CASES)
def test_feature_ops_match_jax(case, nans):
    cols, ts = _cols(nans)
    j = _feature_cases(JFeature, JT)[case]
    p = _feature_cases(Feature, PT)[case]
    assert p.name == j.name
    want = j(_df(cols, ts), backend="jax")
    got = p(_frame(cols, ts), device="cpu")
    _hold(got, want, case, rtol=1e-10, atol=1e-12)


def test_feature_apply_and_rename():
    cols, ts = _cols(False)
    f = Feature(PT.SMA(5, "close")).apply(lambda x, k: x * k, 3.0, suffix="triple")
    assert f.name == "close_sma5_triple"
    got = f(_frame(cols, ts), device="cpu")
    want = pd.Series(cols["close"]).rolling(5).mean().to_numpy() * 3.0
    assert_close(got.numpy(), want, rtol=1e-12, atol=1e-12)
    f.name = "renamed"
    assert f.name == "renamed"
    with pytest.raises(TypeError):
        f.name = ["a"]


def test_compose_matches_jax():
    cols, ts = _cols(False)
    for make in (lambda T: (T.Return(1, "close"), T.SMA(5, "ret1"), T.EWMA(10, "x")),
                 lambda T: (T.SMA(3, "close"), T.ROC(2, "sma3"))):
        jc, pc = JCompose(*make(JT)), Compose(*make(PT))
        assert pc.output_name == jc.output_name
        _hold(pc(_frame(cols, ts), device="cpu"), jc(_df(cols, ts), backend="jax"),
              pc.output_name)
    pc = Compose(*make(PT))
    frame = _frame(cols, ts)
    frame[pc.output_name] = torch.zeros(N, dtype=torch.float64)
    assert pc(frame, device="cpu") is frame[pc.output_name]      # the cache


# --- FeatureKit ---------------------------------------------------------------

def _kit_features(F, T):
    """BASELINE config 4 (``bench.py:595-602``; its z-score at window 20, where
    the 1e-12 bound holds), a feature that reads another's output before it
    (out of order), an operator feature and a calendar feature."""
    return [
        F(T.RealizedVolatility(30, input_col="close_ret1")),
        F(T.EWMA(20, "close")),
        F(T.RSIWilder(14, "close")),
        F(T.ATR(14)),
        F(T.Return(1, "close", is_log=True)),
        F(T.ZScore(20, "close")),
        F(T.SMA(5, "close")) / F(T.SMA(20, "close")),
        F(T.TimeCues("close")),
        F(T.CUSUMTest(20, 10)),
    ]


@pytest.mark.parametrize("fuse_", [False, True], ids=["per_feature", "fused"])
@pytest.mark.parametrize("order", ["defined", "topo"])
def test_kit_build_matches_jax(order, fuse_):
    cols, ts = _cols(False)
    jkit = JFeatureKit(_kit_features(JFeature, JT), retain=["close", "volume"])
    pkit = FeatureKit(_kit_features(Feature, PT), retain=["close", "volume"])
    assert pkit.topological_order() == jkit.topological_order()
    df, frame = _df(cols, ts), _frame(cols, ts)
    if order == "defined":      # the rv feature reads close_ret1 before Return makes it
        ret = np.log(cols["close"][1:] / cols["close"][:-1])
        frame["close_ret1"] = torch.from_numpy(np.concatenate([[np.nan], ret]))
        df = df.assign(close_ret1=frame["close_ret1"].numpy())
    want = jkit.build(df, backend="jax", order=order, fuse=False)
    got = pkit.build(frame, order=order, fuse=fuse_, device="cpu")
    assert list(got) == ["close", "volume", "timestamp"] + [c for c in want.columns
                                                             if c not in ("close", "volume")]
    for c in want.columns:
        _hold(got[c], want[c], c)


def test_fused_equals_per_feature_bit_for_bit():
    cols, ts = _cols(True)
    again = Feature(PT.EWMA(20, "close"))
    again.name = "ewma_again"                             # writes close_ewma20 again
    feats = _kit_features(Feature, PT)[1:] + [
        Feature(PT.ExternalFunction("numpy.log1p", "volume", pass_numpy=True)),
        Feature(PT.SMA(3, "ext_log1p")),                  # reads a host feature's output
        again, _kit_features(Feature, PT)[0]]             # reads close_ret1
    kit = FeatureKit(feats, retain=["close"])
    for order in ("defined", "topo"):
        a = kit.build(_frame(cols, ts), order=order, fuse=False, device="cpu")
        b = kit.build(_frame(cols, ts), order=order, fuse=True, device="cpu")
        assert list(a) == list(b)
        for c in a:
            assert_exact(b[c], a[c], c)
    graph, host = fuse.plan(feats, {c: None for c in cols}, ts)
    assert [f.name for f in host] == ["ext_log1p", "ext_log1p_sma3", "ewma_again"]
    assert len(graph) == len(feats) - 3
    # the planned graph's device run gives the kit's bits for its features
    g, g_ts = fuse.build_fused(feats, _frame(cols, ts))
    outs = g.run_device({c: v for c, v in _frame(cols, ts).items() if c != "timestamp"}, g_ts)
    for f in g.graph_feats:
        names = f.transform.output_name
        if isinstance(names, str):
            assert_exact(outs[names], a[f.name], f.name)
        else:
            for c in names:
                assert_exact(outs[c], a[c], c)


def test_fused_graph_run_and_specs():
    cols, ts = _cols(False)
    feats = [Feature(PT.EWMA(20, "close")), Feature(PT.TimeCues("close"))]
    g = fuse.build_fused_from_specs(feats, {"close": torch.float64}, ts_spec=torch.int64)
    dev = g.run_device(_frame(cols, ts), torch.from_numpy(ts))
    host = g.run(cols, ts, device="cpu")
    assert set(host) == set(dev) and isinstance(host["close_ewma20"], np.ndarray)
    for c in dev:
        assert_exact(host[c], dev[c], c)
    with pytest.raises(ValueError, match="host tiers"):
        fuse.build_fused_from_specs(
            [Feature(PT.ExternalFunction(np.log, "close", pass_numpy=True))], {"close": 0})


def test_kit_timeit_and_profile_dir(tmp_path, capsys, monkeypatch):
    cols, ts = _cols(False)
    kit = FeatureKit(_kit_features(Feature, PT)[1:4])
    ref = kit.build(_frame(cols, ts), device="cpu")
    timed = kit.build(_frame(cols, ts), timeit=True, device="cpu")
    assert "Feature Timing Analysis" in capsys.readouterr().out
    traced = kit.build(_frame(cols, ts), profile_dir=str(tmp_path / "a"), device="cpu")
    monkeypatch.setenv("FMKT_PROFILE_DIR", str(tmp_path / "b"))
    kit.build(_frame(cols, ts), device="cpu")
    for d in ("a", "b"):
        trace = (tmp_path / d / "feature_trace.json").read_text()
        assert "fmkt.feature.close_ewma20" in trace and "fmkt.feature.atr14" in trace
    for c in ref:
        assert_exact(timed[c], ref[c], c)
        assert_exact(traced[c], ref[c], c)


def test_kit_takes_numpy_columns():
    cols, ts = _cols(False)
    kit = FeatureKit([Feature(PT.EWMA(20, "close"))], retain=["close"])
    got = kit.build({**cols, "timestamp": ts}, device="cpu")
    want = kit.build(_frame(cols, ts), device="cpu")
    assert_exact(got["close_ewma20"], want["close_ewma20"])


# --- configs ------------------------------------------------------------------

def _config_features(F, T, side):
    """Features whose configs the JAX package writes in full: its ReturnT,
    BarRate and PctChange drop their windows (ROADMAP R12)."""
    sma = F(T.SMA(5, "close"))
    return [
        F(T.Return(1, "close", is_log=True)),
        F(T.EWMST(_td(side, 600), "close_ret1")),
        F(T.BarDuration(3)),
        (sma / F(T.SMA(20, "close"))).clip(0.99, 1.01),
        F.max(sma, 100.0),
        F(T.Return(1, "close")).rolling_std(10),
        sma.ema(12),
        sma.lag(2),
        F(Compose(T.Return(1, "close"), T.SMA(5, "ret1")) if side == "port" else
          JCompose(T.Return(1, "close"), T.SMA(5, "ret1"))),
        F(T.ExternalFunction("numpy.log1p", "volume", pass_numpy=True)),
        F(T.CUSUMTest(20, 10)),
        F(T.VPIN(16)),
    ]


def test_config_round_trip(tmp_path):
    """The port's configs keep every window, also ReturnT's, BarRate's and
    PctChange's (ROADMAP R12)."""
    cols, ts = _cols(False)
    kit = FeatureKit(_config_features(Feature, PT, "port") + [
        Feature(PT.ReturnT(datetime.timedelta(seconds=300), False, "close")),
        Feature(PT.BarRate(datetime.timedelta(seconds=1800))),
        Feature(PT.PctChange(4, "close"))], retain=["close"])
    kit.save_config(str(tmp_path / "kit.json"))
    again = FeatureKit.from_config(str(tmp_path / "kit.json"))
    from_dict = FeatureKit.from_dict(json.loads(json.dumps(kit.to_config())))
    assert again.to_config() == from_dict.to_config()
    a = kit.build(_frame(cols, ts), device="cpu")
    b = again.build(_frame(cols, ts), device="cpu")
    assert list(a) == list(b)
    for c in a:
        assert_exact(b[c], a[c], c)


def test_jax_saved_config_builds_the_same_kit(tmp_path):
    """A JSON config written by the JAX package's FeatureKit builds the same
    kit in the port: class paths under ``finmlkit_tpu.`` map to
    ``finmlkit_tpu_torch.``, timedeltas and the unary ops by name."""
    cols, ts = _cols(False)
    jkit = JFeatureKit(_config_features(JFeature, JT, "jax"), retain=["close"])
    jkit.save_config(str(tmp_path / "jax.json"))
    pkit = FeatureKit.from_config(str(tmp_path / "jax.json"))
    assert all(type(f.transform).__module__.startswith("finmlkit_tpu_torch.")
               for f in pkit.features if hasattr(f.transform, "_compute"))
    want = jkit.build(_df(cols, ts), backend="jax", fuse=False)
    got = pkit.build(_frame(cols, ts), device="cpu")
    assert list(got) == ["close", "timestamp"] + list(want.columns[1:])
    for c in want.columns:
        _hold(got[c], want[c], c, rtol=1e-10, atol=1e-12)


def test_graph_matches_jax():
    jg = JFeatureKit(_config_features(JFeature, JT, "jax")).build_graph()
    pg = FeatureKit(_config_features(Feature, PT, "port")).build_graph()
    assert pg.edges == jg.edges and pg.nodes == jg.nodes
    assert pg.topological_sort() == jg.topological_sort()
    assert pg.visualize() == jg.visualize()


# --- ExternalFunction --------------------------------------------------------

def _split(x, y):
    return x + y, x - y


def _numpy_only(x):
    assert isinstance(x, np.ndarray)
    return np.cumsum(x)


@pytest.mark.parametrize("how", ["callable", "path"])
@pytest.mark.parametrize("pass_numpy", [False, True])
def test_external_function(how, pass_numpy):
    cols, ts = _cols(False)
    frame, df = _frame(cols, ts), _df(cols, ts)
    one = (torch.log if not pass_numpy else np.log) if how == "callable" else \
        ("torch.log" if not pass_numpy else "numpy.log")
    t = PT.ExternalFunction(one, "close", "lc", pass_numpy=pass_numpy)
    got = t(frame, device="cpu")
    assert_close(got.numpy(), np.log(cols["close"]), rtol=1e-15)
    two = PT.ExternalFunction(_split if how == "callable" else f"{__name__}._split",
                              ["high", "low"], ["s", "d"], pass_numpy=pass_numpy)
    jtwo = JT.ExternalFunction(_split, ["high", "low"], ["s", "d"], pass_numpy=pass_numpy)
    _hold(two(frame, device="cpu"), jtwo(df), "two outputs")
    with pytest.raises(ValueError, match="returned 2 outputs"):
        PT.ExternalFunction(_split, ["high", "low"], ["s", "d", "e"])(frame, device="cpu")
    if pass_numpy:
        got = PT.ExternalFunction(_numpy_only, "volume", args=[], pass_numpy=True)(
            frame, device="cpu")
        assert torch.is_tensor(got) and got.device.type == "cpu"


def test_external_function_kwargs_and_scalar():
    cols, ts = _cols(False)
    t = PT.ExternalFunction(np.clip, "close", "c", kwargs={"a_min": 95.0, "a_max": 105.0},
                            pass_numpy=True)
    assert_close(t(_frame(cols, ts), device="cpu").numpy(),
                 np.clip(cols["close"], 95.0, 105.0), rtol=0)
    s = PT.ExternalFunction(lambda x: 7.0, "close", "seven")(_frame(cols, ts), device="cpu")
    assert s.shape == (N,) and bool((s == 7.0).all())
