"""The port's ``TBMLabel`` and ``SampleWeights`` (``finmlkit_tpu_torch/label/
kit.py``) against the JAX kit on ``tests/labels/test_label_kit.py``'s scenario:
20,000 trades at 100 ms, an event every 500 trades, targets 0.002.

Integers (event and touch indices, labels, touch times) exact; returns and
the vertical-touch weights, differences of log prices, within rtol 1e-12 of
the log prices' magnitude; uniqueness and attribution by
``assert_window_close`` (rtol 1e-12 of their prefix magnitude); the final
weights within rtol 1e-12. Validation errors are held to the JAX kit's by
message: where the JAX message names a pandas type or the index, the port's
names the frame, the tensor or the length (``PORT_MESSAGE``).
"""
import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu.bar import TradesData as JTradesData
from finmlkit_tpu.label import SampleWeights as JSampleWeights
from finmlkit_tpu.label import TBMLabel as JTBMLabel
from finmlkit_tpu_torch.bar.data_model import TradesData
from finmlkit_tpu_torch.label import SampleWeights, TBMLabel
from finmlkit_tpu_torch.label.kit import seconds_to_ns
from finmlkit_tpu_torch.testing import assert_close, assert_exact, assert_window_close

RTOL = 1e-12
N = 20_000


class Seconds:
    """A span the JAX kit reads through ``total_seconds()``, at any float
    (a ``pandas.Timedelta`` holds whole ns only)."""

    def __init__(self, s):
        self.s = s

    def total_seconds(self):
        return self.s


@pytest.fixture(scope="module")
def raw():
    r = np.random.default_rng(0)
    dt = (r.exponential(100.0, N) * 1e6).astype(np.int64)
    ts = 1_700_000_000_000_000_000 + np.cumsum(dt)
    px = np.round(100 * np.exp(np.cumsum(r.normal(0, 2e-4, N))), 2)
    amt = (r.random(N) + 0.01).astype(np.float32)
    return ts, px, amt, np.arange(N, dtype=np.int64)


@pytest.fixture(scope="module")
def trades(raw):
    j = JTradesData(*raw, timestamp_unit="ns", preprocess=True)
    p = TradesData(*raw, timestamp_unit="ns", preprocess=True)
    return j, p


def _features(trades, every=500, tgt=0.002):
    """The scenario's features: a DataFrame for the JAX kit and a frame of
    CPU tensors for the port's."""
    j, _ = trades
    df = j.data.iloc[::every][["price"]].copy()
    df["tgt"] = tgt
    return df


def _frame(df):
    f = {"timestamp": torch.from_numpy(df.index.values.astype("datetime64[ns]").view(np.int64))}
    for c in df.columns:
        f[c] = torch.from_numpy(df[c].to_numpy().copy())
    return f


def _kits(df, **kw):
    args = dict(target_ret_col="tgt", min_ret=0.0, horizontal_barriers=(1.0, 1.0),
                vertical_barrier=1800.0)
    args.update(kw)
    jargs = dict(args)
    for k in ("vertical_barrier", "min_close_time"):
        if k in jargs:
            jargs[k] = Seconds(jargs[k])
    return JTBMLabel(df, **jargs), TBMLabel(_frame(df), **args)


def _ns(index):
    return index.values.astype("datetime64[ns]").view(np.int64)


def _assert_labels(pk, jk, trades):
    jf, jo = jk.features, jk.full_output
    pf, po = pk.features, pk.full_output
    assert_exact(pf["timestamp"], _ns(jf.index), "features index")
    for c in jf.columns:
        assert_exact(pf[c], jf[c].to_numpy(), f"features.{c}")
    assert_exact(po["timestamp"], _ns(jo.index), "output index")
    assert list(po)[1:] == list(jo.columns)
    assert_exact(po["touch_time"], _ns(pd.DatetimeIndex(jo["touch_time"])), "touch_time")
    for c in ("event_idx", "touch_idx"):
        assert_exact(po[c], jo[c].to_numpy().astype(np.int64), c)
    assert_exact(po["labels"], jo["labels"].to_numpy().astype(np.int8), "labels")
    scale = float(np.abs(np.log(trades[1].data["price"])).max())
    assert_window_close(po["returns"], jo["returns"].to_numpy(), scale, RTOL, "returns")
    assert_window_close(po["vertical_touch_weights"],
                        jo["vertical_touch_weights"].to_numpy(), scale / 0.002, RTOL,
                        "vertical_touch_weights")
    assert pk.event_count == jk.event_count > 0


# --- validation, by message ------------------------------------------------

PORT_MESSAGE = {
    "Target column 'nope' not found in features DataFrame.":
        "Target column 'nope' not found in features frame.",
    "Features index must be a DatetimeIndex.":
        "Features must hold int64 ns timestamps under 'timestamp'.",
    "For meta labeling, 'side' column must be present in features DataFrame.":
        "For meta labeling, 'side' column must be present in features frame.",
    "Events must be a pandas DataFrame.": "Events must be a frame (a dict of tensors).",
    "Events DataFrame must contain 'event_idx' and 'touch_idx' columns.":
        "Events frame must contain 'event_idx' and 'touch_idx' columns.",
    "avg_uniqueness must be a pandas Series.": "avg_uniqueness must be a 1-D tensor.",
    "return_attribution must be a pandas Series.": "return_attribution must be a 1-D tensor.",
    "avg_uniqueness and return_attribution must have the same index.":
        "avg_uniqueness and return_attribution must have the same length.",
    "avg_uniqueness and labels must have the same index.":
        "avg_uniqueness and labels must have the same length.",
}


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _same_error(jfn, pfn):
    want = _message(jfn)
    assert _message(pfn) == PORT_MESSAGE.get(want, want)


CTOR_ERRORS = {
    "missing_target": dict(target_ret_col="nope"),
    "bad_barriers_short": dict(horizontal_barriers=(1.0,)),
    "bad_barriers_list": dict(horizontal_barriers=[1.0, 1.0]),
    "negative_min_ret": dict(min_ret=-0.1),
    "meta_without_side": dict(is_meta=True),
    "min_ret_drops_all": dict(min_ret=0.01),
}


@pytest.mark.parametrize("name", list(CTOR_ERRORS))
def test_constructor_errors_match_jax(trades, name):
    df = _features(trades)
    kw = CTOR_ERRORS[name]
    args = dict(target_ret_col="tgt", min_ret=0.0, horizontal_barriers=(1.0, 1.0))
    args.update(kw)
    _same_error(lambda: JTBMLabel(df, vertical_barrier=Seconds(60.0), **args),
                lambda: TBMLabel(_frame(df), vertical_barrier=60.0, **args))


def test_frame_errors_match_jax(trades):
    df = _features(trades)
    args = dict(target_ret_col="tgt", min_ret=0.0, horizontal_barriers=(1.0, 1.0),
                vertical_barrier=60.0)
    jargs = {**args, "vertical_barrier": Seconds(60.0)}
    f = _frame(df)
    # no timestamps, and float timestamps
    _same_error(lambda: JTBMLabel(df.reset_index(drop=True), **jargs),
                lambda: TBMLabel({k: v for k, v in f.items() if k != "timestamp"}, **args))
    _same_error(lambda: JTBMLabel(df.reset_index(drop=True), **jargs),
                lambda: TBMLabel({**f, "timestamp": f["timestamp"].double()}, **args))
    # a float side for meta labels
    dfs = df.assign(side=1.5)
    _same_error(lambda: JTBMLabel(dfs, is_meta=True, **jargs),
                lambda: TBMLabel(_frame(dfs), is_meta=True, **args))
    # every column NaN
    idx = pd.date_range("2024-01-01", periods=5, freq="1min")
    dfn = pd.DataFrame({"tgt": [np.nan] * 5}, index=idx)
    _same_error(lambda: JTBMLabel(dfn, **jargs), lambda: TBMLabel(_frame(dfn), **args))
    # labels and weights before and without trades
    jk, pk = _kits(df)
    for prop in ("labels", "event_returns", "full_output"):
        _same_error(lambda: getattr(jk, prop), lambda: getattr(pk, prop))
    _same_error(lambda: jk.compute_labels(df), lambda: pk.compute_labels(f))
    _same_error(lambda: JSampleWeights.compute_info_weights("nope", df),
                lambda: SampleWeights.compute_info_weights("nope", f))
    _same_error(lambda: JSampleWeights.compute_info_weights(trades[0], "x"),
                lambda: SampleWeights.compute_info_weights(trades[1], "x"))
    _same_error(lambda: JSampleWeights.compute_info_weights(trades[0], pd.DataFrame({"x": [1]})),
                lambda: SampleWeights.compute_info_weights(trades[1], {"x": torch.ones(1)}))


# --- preprocessing ----------------------------------------------------------

def _trim_cases(df):
    n = len(df)
    extra = np.concatenate([[np.nan] * 3, np.ones(n - 3)])
    small = df["tgt"].to_numpy().copy()
    small[:n // 2] = 1e-6
    nan_tgt = df["tgt"].to_numpy().copy()
    nan_tgt[10] = np.nan
    return {
        "leading_nans": (df.assign(extra=extra), {}),
        "leading_nans_and_int": (df.assign(extra=extra, count=np.arange(n)), {}),
        "min_ret": (df.assign(tgt=small), dict(min_ret=0.001)),
        "barrier_multiplier": (df.assign(tgt=0.0006), dict(min_ret=0.001,
                                                          horizontal_barriers=(1.0, 2.0))),
        "nan_target_dropped": (df.assign(tgt=nan_tgt), {}),
        "all_nan_column": (df.assign(empty=np.nan, extra=extra), {}),
    }


@pytest.mark.parametrize("case", ["leading_nans", "leading_nans_and_int", "min_ret",
                                  "barrier_multiplier", "nan_target_dropped",
                                  "all_nan_column"])
def test_trims_match_jax(trades, case):
    df, kw = _trim_cases(_features(trades))[case]
    jk, pk = _kits(df, **kw)
    assert pk.event_count == jk.event_count < len(df) or case == "barrier_multiplier"
    assert pk.first_event_timestamp == jk.first_event_timestamp.value
    assert pk.last_event_timestamp == jk.last_event_timestamp.value
    assert str(pk.event_count) in pk.event_range
    for c in jk.features.columns:
        assert_exact(pk.features[c], jk.features[c].to_numpy(), c)
    assert_exact(pk.target_returns, jk.target_returns.to_numpy(), "target")


# --- labels -----------------------------------------------------------------

@pytest.fixture(scope="module")
def labelled(trades):
    """The scenario labelled by both kits, as ``test_label_kit.py`` does."""
    jk, pk = _kits(_features(trades))
    jk.compute_labels(trades[0])
    pk.compute_labels(trades[1])
    return jk, pk


def test_labels_match_jax(trades, labelled):
    _assert_labels(labelled[1], labelled[0], trades)


@pytest.mark.parametrize("case", ["event_idx", "meta", "min_close_time"])
def test_label_variants_match_jax(trades, case):
    df = _features(trades)
    kw = {}
    if case == "event_idx":        # the frame's own event indices (not searchsorted)
        df = df.assign(event_idx=np.arange(0, N, 500) + 7)
    elif case == "meta":
        df = df.assign(side=np.where(np.arange(len(df)) % 2 == 0, 1, -1))
        kw = dict(is_meta=True, min_ret=0.0005)
    else:
        kw = dict(min_close_time=600.0, horizontal_barriers=(2.0, 0.5))
    jk, pk = _kits(df, **kw)
    jk.compute_labels(trades[0])
    _, out = pk.compute_labels(trades[1])
    _assert_labels(pk, jk, trades)
    if case == "meta":
        assert set(out["labels"].tolist()) <= {0, 1}


@pytest.mark.parametrize("seconds", [0.1, 2.5e-9, 1800.000000001, 1.5e-9, 2.0000000005])
def test_fractional_vertical_barrier_cut(trades, seconds):
    """The trailing-event cut takes the barrier's ns as ``pandas.Timedelta(x,
    unit="s")`` does: events at the last trade's time less a few ns around
    the barrier, kept or dropped as the JAX kit keeps or drops them."""
    ns = pd.Timedelta(seconds, unit="s").value
    assert seconds_to_ns(seconds) == ns
    last = int(trades[1].data["timestamp"][-1])
    df = _features(trades)
    t_ev = last - ns + np.array([-1, 0, 1, 2])
    tail = pd.DataFrame({"price": 100.0, "tgt": 0.002}, index=pd.DatetimeIndex(t_ev))
    df = pd.concat([df.iloc[:-20], tail])
    jk, pk = _kits(df, vertical_barrier=seconds)
    jk.compute_labels(trades[0])
    pk.compute_labels(trades[1])
    _assert_labels(pk, jk, trades)
    assert_exact(pk.features["timestamp"][-2:], t_ev[:2], "the kept tail")


def test_seconds_to_ns_matches_pandas():
    r = np.random.default_rng(4)
    xs = np.concatenate([r.random(3000) * s for s in (1e-8, 1e-3, 1.0, 3600.0, 1e7)])
    xs = np.concatenate([xs, (np.floor(xs * 1e9) + 0.5) / 1e9])
    assert [seconds_to_ns(x) for x in xs.tolist()] == \
        [pd.Timedelta(x, unit="s").value for x in xs.tolist()]


# --- weights ----------------------------------------------------------------

@pytest.fixture(scope="module")
def info(trades, labelled):
    jk, pk = labelled
    return jk.compute_weights(trades[0]), pk.compute_weights(trades[1])


def _prefix_scales(trades, labelled):
    """The prefix magnitudes of the uniqueness and the attribution."""
    jk = labelled[0]
    conc = np.zeros(N + 1)
    out = jk.full_output
    np.add.at(conc, out["event_idx"].to_numpy(), 1)
    np.add.at(conc, out["touch_idx"].to_numpy() + 1, -1)
    conc = np.cumsum(conc)[:-1]
    inv = np.where(conc > 0, 1.0 / np.maximum(conc, 1), 0.0)
    px = trades[1].data["price"]
    lr = np.concatenate([[0.0], np.log(px[1:] / px[:-1])])
    lr = np.where(conc > 0, lr / np.maximum(conc, 1), 0.0)
    return inv.sum(), np.abs(np.cumsum(lr)).max()


@pytest.mark.parametrize("normalize", [False, True])
def test_info_weights_match_jax(trades, labelled, normalize):
    jk, pk = labelled
    jw = jk.compute_weights(trades[0], normalized=normalize)
    pw = pk.compute_weights(trades[1], normalized=normalize)
    assert list(pw) == ["timestamp", *jw.columns]
    assert_exact(pw["timestamp"], _ns(jw.index), "index")
    u_scale, r_scale = _prefix_scales(trades, labelled)
    assert_window_close(pw["avg_uniqueness"], jw["avg_uniqueness"].to_numpy(), u_scale,
                        RTOL, "uniqueness")
    raw = jk.compute_weights(trades[0])["return_attribution"].to_numpy()
    factor = len(raw) / raw.sum() if normalize else 1.0
    assert_window_close(pw["return_attribution"], jw["return_attribution"].to_numpy(),
                        r_scale * factor, RTOL, "attribution")


OPTIONALS = [(ra, vtw, lab) for ra in (False, True) for vtw in (False, True)
             for lab in (False, True)]


@pytest.mark.parametrize("intercept", [-1, -0.5, 0, 0.5, 1])
@pytest.mark.parametrize("ra,vtw,lab", OPTIONALS)
def test_final_weights_match_jax(labelled, info, ra, vtw, lab, intercept):
    jk, pk = labelled
    jw, pw = info
    jo, po = jk.full_output, pk.full_output
    jkw = dict(return_attribution=jw["return_attribution"] if ra else None,
               vertical_touch_weights=jo["vertical_touch_weights"] if vtw else None,
               labels=jo["labels"] if lab else None)
    pkw = dict(return_attribution=pw["return_attribution"] if ra else None,
               vertical_touch_weights=po["vertical_touch_weights"] if vtw else None,
               labels=po["labels"] if lab else None)
    want = JSampleWeights.compute_final_weights(jw["avg_uniqueness"], intercept, **jkw)
    got = SampleWeights.compute_final_weights(pw["avg_uniqueness"], intercept, **pkw)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert_close(got[c], want[c].to_numpy(), rtol=RTOL, what=c)
    if intercept > -1:
        assert bool(torch.isfinite(got["weights"]).all())


def test_final_weight_errors_match_jax(labelled, info):
    jw, pw = info
    ju, pu = jw["avg_uniqueness"], pw["avg_uniqueness"]
    jr, pr = jw["return_attribution"], pw["return_attribution"]
    jl, pl = labelled[0].labels, labelled[1].labels
    cases = [
        (lambda: JSampleWeights.compute_final_weights(ju.to_numpy()),
         lambda: SampleWeights.compute_final_weights(pu.numpy())),
        (lambda: JSampleWeights.compute_final_weights(ju, "0.5"),
         lambda: SampleWeights.compute_final_weights(pu, "0.5")),
        (lambda: JSampleWeights.compute_final_weights(ju, 1.5),
         lambda: SampleWeights.compute_final_weights(pu, 1.5)),
        (lambda: JSampleWeights.compute_final_weights(ju, return_attribution=jr.to_numpy()),
         lambda: SampleWeights.compute_final_weights(pu, return_attribution=pr.numpy())),
        (lambda: JSampleWeights.compute_final_weights(ju, return_attribution=jr.iloc[1:]),
         lambda: SampleWeights.compute_final_weights(pu, return_attribution=pr[1:])),
        (lambda: JSampleWeights.compute_final_weights(ju, labels=jl.iloc[1:]),
         lambda: SampleWeights.compute_final_weights(pu, labels=pl[1:])),
        (lambda: JSampleWeights.compute_final_weights(ju, return_attribution=-jr),
         lambda: SampleWeights.compute_final_weights(pu, return_attribution=-pr)),
        (lambda: JSampleWeights.compute_final_weights(ju, vertical_touch_weights=ju * 0),
         lambda: SampleWeights.compute_final_weights(pu, vertical_touch_weights=pu * 0)),
    ]
    for jfn, pfn in cases:
        _same_error(jfn, pfn)
