"""The port's HDF5 trade store (``finmlkit_tpu_torch/data/store.py``) against
the JAX package's (``finmlkit_tpu/data/store.py``) on the CPU.

Files cross both ways: a store the JAX package writes loads in the port, and
the other way round, and both packages write the same datasets (values and
dtypes), meta attrs and integrity tables. The time-range cases of
``tests/bars/test_store_filtering.py`` run against JAX's
``_keys_for_timerange`` and ``load_trades_h5``; the port reads times as
``bar/data_model._to_ns`` does, so it gets the ns of the pandas Timestamp the
JAX side gets. ``H5Inspector`` gives dicts of numpy columns (times in int64
ns) equal, column for column, to the JAX DataFrames. Everything exact.
"""
import os
import shutil

import h5py
import numpy as np
import pandas as pd
import pytest

from finmlkit_tpu.bar.data_model import TradesData as JTradesData
from finmlkit_tpu.data import store as jstore
from finmlkit_tpu_torch.bar.data_model import TradesData
from finmlkit_tpu_torch.data import store
from finmlkit_tpu_torch.testing import assert_exact

MONTH_STARTS = ("2021-01-15", "2021-02-10", "2021-03-05")


def _sample(n=24, start="2021-01-15 00:00:00", freq="h"):
    idx = pd.date_range(start=start, periods=n, freq=freq)
    ts = idx.as_unit("ns").asi8
    px = np.linspace(100.0, 101.0, n)
    qty = np.linspace(1.0, 2.0, n).astype(np.float32)
    ids = np.arange(1, n + 1, dtype=np.int64)
    return ts, px, qty, ids, idx


def _side(n):
    return np.where(np.arange(n) % 3 == 0, -1, 1).astype(np.int8)


def _gappy(n=400, seed=0, start="2021-04-03"):
    """Preprocessed trades with id gaps, two of them over a minute apart
    (discontinuities, ``data_ok`` False) and one within it."""
    r = np.random.default_rng(seed)
    ts = pd.Timestamp(start).value + np.cumsum(r.integers(1, 5 * 10**9, n))
    ts[150:] += 120 * 10**9
    ts[300:] += 600 * 10**9
    ids = np.arange(n, dtype=np.int64) + 1000
    ids[150:] += 7
    ids[300:] += 3
    ids[50:] += 2
    px = np.round(100 + np.cumsum(r.normal(0, 0.05, n)), 2)
    qty = np.round(r.lognormal(-2, 1, n), 4).astype(np.float32)
    maker = r.random(n) < 0.5
    return ts, px, qty, ids, maker


def _pair(ts, px, qty, ids, **kw):
    return (JTradesData(ts, px, qty, ids, timestamp_unit="ns", **kw),
            TradesData(ts, px, qty, ids, timestamp_unit="ns", **kw))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The same four months written by each package: the three hourly months
    of ``test_store_filtering.py`` with sides, and a preprocessed month with
    discontinuities."""
    d = tmp_path_factory.mktemp("stores")
    paths = {"jax": str(d / "jax.h5"), "port": str(d / "port.h5")}
    for start in MONTH_STARTS:
        ts, px, qty, ids, _ = _sample(start=start)
        j, p = _pair(ts, px, qty, ids, side=_side(len(ts)), preprocess=False)
        assert j.save_h5(paths["jax"]) == p.save_h5(paths["port"])
    ts, px, qty, ids, maker = _gappy()
    j, p = _pair(ts, px, qty, ids, is_buyer_maker=maker, preprocess=True)
    assert p.discontinuities and len(p.discontinuities) == len(j.discontinuities) == 2
    assert jstore.save_trades_h5(j, paths["jax"]) == store.save_trades_h5(p, paths["port"])
    return paths


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[:], obj.compression)
            else:
                out[name] = dict(obj.attrs)
        f.visititems(visit)
    return out


def test_both_packages_write_the_same_file(stores):
    j, p = _datasets(stores["jax"]), _datasets(stores["port"])
    assert sorted(j) == sorted(p)
    assert any(k.startswith("integrity/2021-04/") for k in p)
    for k, want in j.items():
        if isinstance(want, dict):      # a group's attrs
            assert p[k].keys() == want.keys(), k
            for a, v in want.items():
                assert type(p[k][a]) is type(v) and p[k][a] == v, (k, a)
        else:
            assert p[k][1] == want[1], k       # lzf, but the integrity tables
            assert (want[1] == "lzf") == k.startswith("trades/"), k
            assert_exact(p[k][0], want[0], k)


def _hold(port_td, jax_td):
    """A port ``TradesData`` equal to a JAX one: columns, values and dtypes
    (the JAX class keeps an ``id`` column of None where it has no ids; the
    port keeps none)."""
    d = jax_td.data
    assert d["id"].isna().all()
    d = d.drop(columns="id")
    assert sorted(port_td.data) == sorted(d.columns)
    for c in d.columns:
        assert_exact(port_td.data[c], d[c].values, c)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_files_cross_both_ways(stores, writer):
    path = stores[writer]
    want = jstore.load_trades_h5(path)
    _hold(store.load_trades_h5(path), want)
    _hold(TradesData.load_trades_h5(path), want)
    assert len(want.data) == 3 * 24 + 400


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("start, end, key", [
    (("2021-01-15", 3), ("2021-01-15", 8), None),    # inclusive boundaries
    ("2021-01-20", "2021-02-28", None),               # spans months, Jan's rows gone
    ("2021-03-01", None, None),
    (None, "2021-01-31", None),
    (None, None, "2021-02"),
    (None, None, "/trades/2021-04"),
    (("2021-02-10", 5), ("2021-02-10", 10), "2021-02"),
    ("2021-01-31T23:59:59", "2021-04-03T00:10:00", None),
    ("2021-04-03T00:05:00.123456789", None, None),
])
def test_time_range_loads_match_jax(stores, writer, start, end, key):
    def times(t):
        if isinstance(t, tuple):    # the i-th hour of a sample month, a pandas Timestamp
            t = _sample(start=t[0])[4][t[1]]
        return t, (None if t is None else pd.Timestamp(t).value)

    (j_start, p_start), (j_end, p_end) = times(start), times(end)
    want = jstore.load_trades_h5(stores[writer], key=key, start_time=j_start,
                                 end_time=j_end)
    got = store.load_trades_h5(stores[writer], key=key, start_time=p_start,
                               end_time=p_end)
    _hold(got, want)
    if isinstance(start, str) and start[-1] != "9":  # ISO strings read alike
        _hold(store.load_trades_h5(stores[writer], key=key, start_time=start,
                                   end_time=end), want)


@pytest.mark.parametrize("kw, err, match", [
    (dict(start_time="2030-01-01", end_time="2030-02-01"), ValueError,
     "No monthly groups overlap"),
    (dict(key="2022-09"), KeyError, "not in store"),
])
def test_bad_ranges_raise_as_jax(stores, kw, err, match):
    with pytest.raises(err, match=match):
        jstore.load_trades_h5(stores["jax"], **kw)
    with pytest.raises(err, match=match):
        store.load_trades_h5(stores["jax"], **kw)


@pytest.mark.parametrize("keys, lo, hi", [
    (["2021-01", "2021-02", "2021-03", "2021-04"], "2021-02-15", "2021-03-10"),
    (["2021-01", "2021-02", "2021-03"], None, None),
    (["2021-01", "2021-02", "2021-03"], "2021-03-02", None),
    (["2021-01", "2021-02", "2021-03"], None, "2021-01-30"),
    (["2021-01", "2021-02"], "2021-01-31 23:59:59", None),
    (["2021-01", "2021-02"], "2021-02-01", None),         # Jan's end is Feb's first instant
    (["2021-01", "2021-02"], "2021-02-01 00:00:00.000000001", None),
    (["2021-01", "2021-02"], None, "2021-02-01"),
    (["2021-01", "2021-02"], None, "2021-01-31 23:59:59.999999999"),
    (["2020-02", "2020-12", "2021-01"], "2020-02-29 12:00", "2020-12-31 23:00"),
    (["1969-12", "1970-01"], "1969-12-31 23:00", None),
])
def test_key_pruning_matches_jax(keys, lo, hi):
    lo_ns = None if lo is None else pd.Timestamp(lo).value
    hi_ns = None if hi is None else pd.Timestamp(hi).value
    assert store._keys_for_timerange(keys, lo_ns, hi_ns) == \
        jstore._keys_for_timerange(keys, lo_ns, hi_ns)


@pytest.mark.parametrize("key, start, end", [("2021-01", "2021-01-01", "2021-02-01"),
                                             ("2020-02", "2020-02-01", "2020-03-01"),
                                             ("2020-12", "2020-12-01", "2021-01-01"),
                                             ("1969-12", "1969-12-01", "1970-01-01")])
def test_month_bounds(key, start, end):
    assert store.month_bounds(key) == (pd.Timestamp(start).value, pd.Timestamp(end).value)
    assert store.month_key_of(pd.Timestamp(start).value) == key
    assert store.month_key_of(pd.Timestamp(end).value - 1) == key


def test_save_options(tmp_path):
    ts, px, qty, ids, _ = _sample(n=10, start="2021-05-01")
    td = TradesData(ts, px, qty, ids, timestamp_unit="ns")
    path = str(tmp_path / "w.h5")
    assert store.save_trades_h5(td, path, month_key="2021-06") == "/trades/2021-06"
    other = TradesData(ts[:4], px[:4], qty[:4], ids[:4], timestamp_unit="ns")
    store.save_trades_h5(other, path, month_key="2021-06", overwrite_month=False)
    assert len(store.load_trades_h5(path).data["timestamp"]) == 10
    store.save_trades_h5(other, path, month_key="2021-06")
    assert len(store.load_trades_h5(path).data["timestamp"]) == 4
    store.save_trades_h5(td, path, mode="w")        # a new file: only 2021-05
    assert store.H5Inspector(path).list_keys() == ["/trades/2021-05"]
    with pytest.raises(ValueError, match="no trades"):
        store.save_trades_h5(TradesData(ts[:0], px[:0], qty[:0], timestamp_unit="ns"),
                             path)


@pytest.mark.parametrize("kwarg", ["overwrite", "complevel"])
def test_save_rejects_unknown_options(tmp_path, kwarg):
    """A misspelt option raises rather than being dropped: ``overwrite=False``
    for ``overwrite_month=False`` would replace a stored month."""
    ts, px, qty, ids, _ = _sample(n=10, start="2021-05-01")
    td = TradesData(ts, px, qty, ids, timestamp_unit="ns")
    path = str(tmp_path / "w.h5")
    with pytest.raises(TypeError, match=kwarg):
        store.save_trades_h5(td, path, **{kwarg: False})
    with pytest.raises(TypeError, match=kwarg):
        td.save_h5(path, **{kwarg: False})
    assert not os.path.exists(path)


def test_multiprocess_load_matches_sequential(stores):
    seq = store.load_trades_h5(stores["jax"])
    par = store.load_trades_h5(stores["jax"], enable_multiprocessing=True, max_workers=2)
    for c in seq.data:
        assert_exact(par.data[c], seq.data[c], c)


def test_corrupt_group_skipped(stores, monkeypatch):
    orig = store._load_single_group

    def flaky(path, key):
        if key == "2021-02":
            raise OSError("synthetic corruption")
        return orig(path, key)

    monkeypatch.setattr(store, "_load_single_group", flaky)
    got = store.load_trades_h5(stores["port"])
    with h5py.File(stores["port"], "r") as f:
        want = np.concatenate([f[f"trades/{m}/timestamp"][:] for m in
                               ("2021-01", "2021-03", "2021-04")])
    assert_exact(got.data["timestamp"], want)


def test_all_groups_failing_raises(stores, monkeypatch):
    def always_fail(path, key):
        raise OSError("nope")

    monkeypatch.setattr(store, "_load_single_group", always_fail)
    with pytest.raises(ValueError, match="All monthly group loads"):
        store.load_trades_h5(stores["port"])


def test_missing_trades_root_raises(tmp_path):
    p = str(tmp_path / "empty.h5")
    with h5py.File(p, "w") as f:
        f.create_group("other")
    with pytest.raises(KeyError, match="trades"):
        store.load_trades_h5(p)
    assert store.H5Inspector(p).list_keys() == []


def _columns_equal(got: dict, want: pd.DataFrame, times=()):
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].values
        if c in times:
            w = w.astype("datetime64[ns]").view(np.int64)
        elif c == "month":
            w = np.asarray(w, dtype=str)
        assert_exact(got[c], w, c)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_inspector_matches_jax(stores, writer):
    path = stores[writer]
    j, p = jstore.H5Inspector(path), store.H5Inspector(path)
    assert p.list_keys() == j.list_keys()
    for key in j.list_keys():
        assert p.get_metadata(key) == j.get_metadata(key)
        assert p.get_statistics(key) == j.get_statistics(key)
        ji, pi = j.get_integrity_info(key), p.get_integrity_info(key)
        assert (ji is None) == (pi is None) == (key != "/trades/2021-04")
        if ji is not None:
            _columns_equal(pi, ji, times=("pre_gap_time", "post_gap_time"))
    with pytest.raises(KeyError):
        p.get_metadata("/trades/1999-01")
    _columns_equal(p.get_integrity_summary(), j.get_integrity_summary())


@pytest.mark.parametrize("max_gap, processes", [(None, 1), (pd.Timedelta(seconds=90), 2),
                                                (pd.Timedelta(minutes=9), 1)])
def test_inspect_gaps_matches_jax(stores, max_gap, processes):
    want = jstore.H5Inspector(stores["port"]).inspect_gaps(max_gap, processes=processes)
    arg = None if max_gap is None else max_gap.to_pytimedelta()
    got = store.H5Inspector(stores["port"]).inspect_gaps(arg, processes=processes)
    assert len(want) > 0
    want = want.assign(duration=want["duration"].values.astype("timedelta64[ns]")
                       .view(np.int64))
    _columns_equal(got, want, times=("gap_start", "gap_end"))
    if max_gap is not None:         # numpy and int ns thresholds read alike
        for alt in (max_gap.to_timedelta64(), max_gap.value):
            again = store.H5Inspector(stores["port"]).inspect_gaps(alt, processes=1)
            for c in got:
                assert_exact(again[c], got[c], c)


def test_inspect_gaps_none_found(tmp_path, stores):
    path = str(tmp_path / "one.h5")
    shutil.copy(stores["port"], path)
    got = store.H5Inspector(path).inspect_gaps(np.timedelta64(30, "D"), processes=1)
    assert {c: len(v) for c, v in got.items()} == dict.fromkeys(
        ("month", "gap_start", "gap_end", "duration"), 0)


def test_r18_a_column_some_months_lack_is_left_out(tmp_path):
    """The JAX loader concatenates the ``side`` of the months that have one
    beside the timestamps of all (``finmlkit_tpu/data/store.py:169-173``), so
    a store of months with and without sides fails to load (ROADMAP.md, Queue
    3, R18); the port leaves ``side`` out."""
    path = str(tmp_path / "mixed.h5")
    for start, side in (("2021-01-15", None), ("2021-02-10", _side(24))):
        ts, px, qty, ids, _ = _sample(start=start)
        TradesData(ts, px, qty, ids, side=side, timestamp_unit="ns").save_h5(path)
    got = store.load_trades_h5(path)
    assert sorted(got.data) == ["amount", "price", "timestamp"]
    assert len(got.data["timestamp"]) == 48
    assert_exact(store.load_trades_h5(path, key="2021-02").data["side"], _side(24))
    with pytest.raises(ValueError, match="Length of values"):
        jstore.load_trades_h5(path)
