"""The port's ``TradesData`` (``finmlkit_tpu_torch/bar/data_model.py``) and its
trade helpers (``bar/utils.py``) against the JAX package's on seeded trades.

Columns are held exact (values and dtypes); ``missing_pct``, ``data_ok`` and
``discontinuities`` equal, the times as int64 ns and the intervals as
``pandas.Timedelta.to_pytimedelta`` gives them. The JAX class merges with
``is_buyer_maker`` in its input order while it sorts the rows by id (ROADMAP.md,
Queue 3, R13), so where the ids are out of order or repeat, the cases run
without ``is_buyer_maker``, and ``test_maker_follows_the_rows`` holds the port
to the JAX class fed the rows in the order it keeps them. Every kit built from
a ``TradesData`` equals the same kit built from its columns, bit for bit.
"""
import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu.bar import TradesData as JTradesData
from finmlkit_tpu.bar import utils as jutils
from finmlkit_tpu_torch.bar import kit, utils
from finmlkit_tpu_torch.bar.data_model import TradesData
from finmlkit_tpu_torch.testing import assert_exact

T0_NS = 1_700_000_000_000_000_000
UNIT = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}


def _raw(case, n=3000, seed=0):
    """(ts, px, qty, ids, is_buyer_maker, keyword arguments) of one case."""
    r = np.random.default_rng(seed)
    unit = case if case in ("ms", "us") else "ns"
    step = r.exponential(80.0, n) * 1e6 / UNIT[unit]
    step[r.random(n) < 0.2] = 0                    # equal timestamps: split trades
    ts = T0_NS // UNIT[unit] + np.cumsum(np.floor(step)).astype(np.int64)
    px = np.round(100 + np.cumsum(r.normal(0, 0.02, n)), 2)
    qty = np.round(r.lognormal(-2, 1, n), 4).astype(np.float32) + np.float32(1e-4)
    ids = np.arange(10_000, 10_000 + n, dtype=np.int64)
    maker = r.random(n) < 0.5
    kw = {}
    if case == "split":                            # runs of one price and side
        same = r.random(n) < 0.5
        same[0] = False
        ts[1:][same[1:]] = 0
        ts = np.maximum.accumulate(np.where(same, 0, ts))
        px = np.where(same, np.nan, px)
        px = pd.Series(px).ffill().to_numpy()
        maker = np.where(same, np.nan, maker)
        maker = pd.Series(maker).ffill().to_numpy().astype(bool)
    elif case == "duplicates":                     # repeated ids, shuffled rows
        dup = r.choice(n, n // 10, replace=False)
        ids = np.concatenate([ids, ids[dup]])
        ts = np.concatenate([ts, ts[dup] + r.integers(0, 3, len(dup))])
        px = np.concatenate([px, px[dup] + 0.01])
        qty = np.concatenate([qty, qty[dup] * 2])
        perm = r.permutation(len(ids))
        ts, px, qty, ids, maker = ts[perm], px[perm], qty[perm], ids[perm], None
    elif case == "unsorted":                       # shuffled ids, times out of id order
        ts[n // 2:n // 2 + 20] = ts[n // 2:n // 2 + 20][::-1]
        perm = r.permutation(n)
        ts, px, qty, ids, maker = ts[perm], px[perm], qty[perm], ids[perm], None
    elif case == "gaps":                           # id gaps under and over one minute
        for at, missing, secs in ((500, 3, 5), (1200, 40, 61), (2000, 7, 300), (2500, 1, 59)):
            ids[at:] += missing
            ts[at:] += secs * 10**9
    elif case == "drift":                          # sub-1e-8 steps inside a group
        for at in range(100, n - 10, 97):
            ts[at:at + 8] = ts[at]
            px[at:at + 8] = px[at] + np.arange(8) * 3e-9 * (1 if at % 2 else -1)
            maker[at:at + 8] = maker[at]
    elif case == "proc_res":
        kw = {"proc_res": "ms"}
    elif case == "no_maker":
        maker = None
    return ts, px, qty, ids, maker, kw


CASES = ["ms", "us", "ns", "split", "duplicates", "unsorted", "gaps", "drift",
         "proc_res", "no_maker"]


def _pair(case, **extra):
    ts, px, qty, ids, maker, kw = _raw(case)
    kw.update(extra)
    j = JTradesData(ts, px, qty, ids, is_buyer_maker=maker, preprocess=True, **kw)
    p = TradesData(ts, px, qty, ids, is_buyer_maker=maker, preprocess=True, **kw)
    return j, p


def _assert_same(p, j):
    jd = j.data
    assert list(p.data) == ["timestamp", "price", "amount", "side"]
    for c in p.data:
        assert_exact(p.data[c], jd[c].to_numpy(), c)
    assert p.missing_pct == j.missing_pct and p.data_ok == j.data_ok
    assert p.orig_timestamp_unit == j.orig_timestamp_unit
    want = [{**d, "pre_gap_time": d["pre_gap_time"].value,
             "post_gap_time": d["post_gap_time"].value,
             "time_interval": d["time_interval"].to_pytimedelta()}
            for d in j.discontinuities]
    assert p.discontinuities == want


@pytest.mark.parametrize("case", CASES)
def test_preprocess_matches_jax(case):
    j, p = _pair(case)
    _assert_same(p, j)
    n_in = len(_raw(case)[0])
    if case in ("split", "drift", "ms"):
        assert len(p.data["price"]) < n_in          # the case merged something
    if case == "gaps":
        assert len(p.discontinuities) == 2 and not p.data_ok
    if case == "duplicates":
        assert p.data_ok is False


def test_maker_follows_the_rows():
    """R13: with shuffled and repeated ids the port's sides belong to the
    rows it keeps: the JAX class agrees once fed those rows in its order."""
    ts, px, qty, ids, _, _ = _raw("duplicates")
    maker = np.random.default_rng(5).random(len(ids)) < 0.5
    p = TradesData(ts, px, qty, ids, is_buyer_maker=maker, preprocess=True)
    order = np.argsort(ids, kind="quicksort")
    first = np.ones(len(order), bool)
    first[1:] = ids[order][1:] != ids[order][:-1]
    order = order[first]
    order = order[np.lexsort((ids[order], ts[order]))]
    j = JTradesData(ts[order], px[order], qty[order], ids[order],
                    is_buyer_maker=maker[order], preprocess=True)
    for c in ("timestamp", "price", "amount", "side"):
        assert_exact(p.data[c], j.data[c].to_numpy(), c)
    with pytest.raises(ValueError):              # the JAX class on the raw rows
        JTradesData(ts, px, qty, ids, is_buyer_maker=maker, preprocess=True)


@pytest.mark.parametrize("proc_res", ["s", "us"])
def test_proc_res_matches_jax(proc_res):
    _assert_same(*_pair("ns", proc_res=proc_res)[::-1])


def test_without_preprocessing_keeps_the_columns():
    ts, px, qty, ids, _, _ = _raw("ms")
    side = np.where(np.arange(len(ts)) % 3, 1, -1).astype(np.int8)
    j = JTradesData(ts, px, qty, ids, side=side)
    p = TradesData(ts, px, qty, ids, side=side)
    for c in ("timestamp", "price", "amount", "id", "side"):
        assert_exact(p.data[c], j.data[c].to_numpy(), c)
    assert p.data_ok is None and p.orig_timestamp_unit == "ms"


@pytest.mark.parametrize("start,end", [
    ("2023-11-14 22:14:00", "2023-11-14 22:15:30.5"),
    (datetime.datetime(2023, 11, 14, 22, 13, 30), datetime.datetime(2023, 11, 14, 22, 13, 45)),
    (None, None),                                 # the ends on trades' own timestamps
])
def test_view_range_matches_jax(start, end):
    j, p = _pair("ns")
    if start is None:
        t = p.data["timestamp"]
        start, end = int(t[100]), int(t[900])
        j.set_view_range(pd.Timestamp(start), pd.Timestamp(end))
    else:
        j.set_view_range(start, end)
    p.set_view_range(start, end)
    for c in p.data:
        assert_exact(p.data[c], j.data[c].to_numpy(), c)
    assert 0 < len(p.data["price"]) < 3000
    assert p.start_date == pd.Timestamp(j.start_date).value
    t = p.tensors("cpu")
    assert_exact(t["price"], p.data["price"], "tensors")
    assert set(t) == {"timestamp", "price", "amount", "side"}


def test_validation_matches_jax():
    ts, px, qty, ids, _, _ = _raw("ns")
    for cls in (JTradesData, TradesData):
        with pytest.raises(TypeError, match="ts must be a np.ndarray"):
            cls(list(ts), px, qty)
        with pytest.raises(TypeError, match="id must be a np.ndarray"):
            cls(ts, px, qty, list(ids))
        with pytest.raises(ValueError, match="id is required"):
            cls(ts, px, qty, preprocess=True)
        with pytest.raises(ValueError, match="Invalid processing resolution"):
            cls(ts, px, qty, ids, preprocess=True, proc_res="min")
        with pytest.raises(ValueError, match="Invalid timestamp format"):
            cls(ts, px, qty, ids, preprocess=True, timestamp_unit="min")
        with pytest.raises(ValueError, match="Start timestamp must be before"):
            cls(ts, px, qty).set_view_range("2023-11-15", "2023-11-14")


def _helper_cases():
    r = np.random.default_rng(9)
    n = 2000
    px = np.round(50 + np.cumsum(r.normal(0, 0.01, n)), 2)
    px[::7] = px[np.maximum(np.arange(0, n, 7) - 1, 0)]     # unchanged prices
    ts = np.cumsum(r.integers(0, 3, n)).astype(np.int64)
    px2 = px.copy()
    px2[10:30] = px2[10] + np.arange(20) * 6e-9            # anchor drift
    ts[10:30] = ts[10]
    maker = r.random(n) < 0.5
    maker[10:30] = True
    qty = r.random(n).astype(np.float32)
    return ts, px, px2, qty, maker


def test_helpers_match_jax():
    ts, px, px2, qty, maker = _helper_cases()
    assert_exact(utils.comp_trade_side_vector(px), jutils.comp_trade_side_vector(px), "sides")
    for prices in (px, px2):
        for m in (maker, None):
            got = utils.merge_split_trades(ts, prices, qty, m)
            want = jutils.merge_split_trades(ts, prices, qty, m)
            for g, w, c in zip(got, want, ("ts", "px", "amount", "side")):
                assert_exact(g, w, c)
    assert utils.comp_price_tick_size(px) == jutils.comp_price_tick_size(px)
    for a, b, c in ((1.0, 1.0 + 1e-13, -1), (2.0, 1.0, 0), (1.0, 2.0, 1)):
        assert utils.comp_trade_side(a, b, c) == jutils.comp_trade_side(a, b, c)
    for trio in ((1, 2, 3), (3, 1, 2), (2, 3, 1), (5, 5, 1)):
        assert utils.median3(*trio) == jutils.median3(*trio)
    assert utils.check_timestamps_order(ts) and not utils.check_timestamps_order(ts[::-1])
    shuffled = np.random.default_rng(2).permutation(len(ts))
    for g, w in zip(utils.fast_sort_trades(ts[shuffled], px[shuffled], qty[shuffled], maker[shuffled]),
                    jutils.fast_sort_trades(ts[shuffled], px[shuffled], qty[shuffled], maker[shuffled])):
        assert_exact(g, w)


KITS = {
    "time": (kit.TimeBarKit, (datetime.timedelta(seconds=20),), {}),
    "tick": (kit.TickBarKit, (50,), {}),
    "volume": (kit.VolumeBarKit, (25.0,), {}),
    "dollar": (kit.DollarBarKit, (2500.0,), {}),
    "imbalance": (kit.ImbalanceBarKit, ("tick",), {"threshold": 9.0}),
    "run": (kit.RunBarKit, ("volume",), {"threshold": 20.0}),
    "cusum": (kit.CUSUMBarKit, (np.full(2700, 2e-4),), {}),
}


@pytest.mark.parametrize("name", list(KITS))
def test_kit_from_trades_data_equals_columns(name):
    _, p = _pair("split")
    cls, args, kw = KITS[name]
    d = p.data
    if name == "cusum":
        args = (np.full(len(d["price"]), 2e-4),)
    a = cls(p, *args, device="cpu", **kw)
    b = cls(d["timestamp"], d["price"], d["amount"], d["side"], *args, device="cpu", **kw)
    assert_exact(a.bar_close_indices, b.bar_close_indices, "ci")
    assert a.bar_close_indices.shape[0] > 5
    for build in ("build_ohlcv", "build_directional_features"):
        x, y = getattr(a, build)(), getattr(b, build)()
        assert list(x) == list(y)
        for c in x:
            assert_exact(x[c], y[c], f"{build}.{c}")


def test_kit_without_sides():
    ts, px, qty, ids, _, _ = _raw("ns")
    p = TradesData(ts, px, qty, ids)
    k = kit.TimeBarKit(p, 30.0, device="cpu")
    assert torch.is_tensor(k.build_ohlcv()["close"])
    with pytest.raises(ValueError, match="no sides"):
        k.build_directional_features()
