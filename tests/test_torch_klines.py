"""The port's 1-second klines (``finmlkit_tpu_torch/data/klines.py``) against
the JAX package's (``finmlkit_tpu/data/klines.py``) on the CPU.

Two copies of one store, two months (2024-02-29 to 2024-03-02, over a month's
and two days' ends), with 30 empty seconds and a second that holds 1500 trades:
each package's ``AddTimeBarH5`` builds the klines in its copy, and the
datasets and ``klines_meta`` attrs are equal (values and dtypes). The port's
``TimeBarReader.read`` equals JAX's at 1 s, over ranges, and resampled at
``1min``, ``5min``, ``1h`` and ``1D`` (with the end-at-midnight rule): OHLC,
trades and the median exact (values and dtypes), volume and vwap within 2
float32 ulps (rtol 2^-22; pandas sums the float32 volume in float32 with
compensation, the port in float64, each rounds once). ``resample`` on frames
with NaNs and ties equals the JAX ``_resample`` on the same DataFrame. The
timeframes accepted and refused are those of pandas' ``DatetimeIndex.floor``.
"""
import shutil

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu.bar.data_model import TradesData as JTradesData
from finmlkit_tpu.data import klines as jklines
from finmlkit_tpu_torch.data import klines
from finmlkit_tpu_torch.testing import assert_close, assert_exact
from tests.conftest import generate_trades

RTOL_SUMS = 2.0 ** -22
EXACT = ("open", "high", "low", "close", "trades", "median_trade_size")


def _trades(n=6000, seed=1):
    """Trades from 2024-02-29 23:50, a 30 s gap after trade 1000, trades
    2000-3499 in one second (more than half of their 5 minutes), and a day's
    jump after trade 4000 (into 2024-03-01 and over midnight into
    2024-03-02)."""
    ts, px, amt, side = generate_trades(n=n, seed=seed, start="2024-02-29 23:50:00")
    ts = ts.copy()
    ts[1000:] += 30 * 10**9
    sec = ts[2000] // 10**9 * 10**9 + 10**9
    ts[2000:3500] = sec + 100_000_000 + np.arange(1500) * 400_000
    ts[3500:] += ts[3499] + 10**9 - ts[3500]
    ts[4000:] += 86_400 * 10**9
    return ts, px, amt, side


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """``{"jax": path, "port": path}``: one store of two months, the JAX
    klines built in the first copy and the port's in the second."""
    d = tmp_path_factory.mktemp("klines")
    jax_path, port_path = str(d / "jax.h5"), str(d / "port.h5")
    ts, px, amt, _ = _trades()
    ids = np.arange(len(ts), dtype=np.int64)
    feb = ts < pd.Timestamp("2024-03-01").value
    for m in (feb, ~feb):
        JTradesData(ts[m], px[m], amt[m], ids[m], timestamp_unit="ns",
                    preprocess=True).save_h5(jax_path)
    shutil.copy(jax_path, port_path)
    assert all(jklines.AddTimeBarH5(jax_path).process_all().values())
    got = klines.AddTimeBarH5(port_path, device="cpu").process_all()
    assert got == {"/trades/2024-02": True, "/trades/2024-03": True}
    return {"jax": jax_path, "port": port_path}


def _klines(path):
    out = {}
    with h5py.File(path, "r") as f:
        for grp in ("klines", "klines_meta"):
            for month, g in f[grp].items():
                out[(grp, month)] = dict(g.attrs)
                for name, ds in g.items():
                    out[(grp, month, name)] = (ds[:], ds.compression)
    return out


def test_both_packages_build_the_same_klines(stores):
    j, p = _klines(stores["jax"]), _klines(stores["port"])
    assert sorted(j) == sorted(p)
    march = j[("klines", "2024-03", "timestamp")][0]
    assert march[0] < pd.Timestamp("2024-03-02").value < march[-1]
    for k, want in j.items():
        if isinstance(want, dict):
            assert p[k].keys() == want.keys(), k
            for a, v in want.items():
                assert type(p[k][a]) is type(v) and p[k][a] == v, (k, a)
        else:
            assert p[k][1] == want[1] == "lzf", k
            assert_exact(p[k][0], want[0], str(k))
    trades = j[("klines", "2024-02", "trades")][0]
    assert (trades == 0).sum() >= 29 and trades.max() == 1500   # empty and dominant seconds


def test_skip_and_overwrite(stores, tmp_path):
    path = str(tmp_path / "again.h5")
    shutil.copy(stores["port"], path)
    add = klines.AddTimeBarH5(path, keys=["2024-03"], device="cpu")
    assert add.keys == ["/trades/2024-03"]
    assert add.process_all() == {"/trades/2024-03": False}
    assert add.process_all(overwrite=True) == {"/trades/2024-03": True}
    assert _klines(path).keys() == _klines(stores["port"]).keys()
    for k, v in _klines(path).items():
        if not isinstance(v, dict):
            assert_exact(v[0], _klines(stores["port"])[k][0], str(k))
    with pytest.raises(KeyError, match="Missing keys"):
        klines.AddTimeBarH5(path, keys=["2024-05"], device="cpu")


def test_a_failing_month_is_reported(stores, tmp_path, monkeypatch):
    path = str(tmp_path / "fail.h5")
    shutil.copy(stores["port"], path)

    def boom(*a, **kw):
        raise RuntimeError("synthetic")

    monkeypatch.setattr(klines, "build_klines", boom)
    assert klines.AddTimeBarH5(path, device="cpu").process_all(overwrite=True) == \
        {"/trades/2024-02": False, "/trades/2024-03": False}


def _hold(got: dict, want: pd.DataFrame, what=""):
    """The port's frame equal to a JAX DataFrame (see the module docstring)."""
    assert list(got) == ["timestamp", *want.columns], what
    assert_exact(got["timestamp"], want.index.values.astype("datetime64[ns]").view(np.int64),
                 f"{what} timestamp")
    for c in want.columns:
        if c in EXACT:
            assert_exact(got[c], want[c].values, f"{what} {c}")
        else:
            assert got[c].dtype == getattr(torch, str(want[c].dtype)), (what, c)
            assert_close(got[c], want[c].values, rtol=RTOL_SUMS, what=f"{what} {c}")


RANGES = [(None, None), ("2024-03-01T00:00:00", None), (None, "2024-03-01T00:00:00"),
          ("2024-02-29T23:55:00", "2024-03-02T00:02:00"),
          ("2024-03-01T23:59:30.5", "2024-03-02T00:00:00"),
          ("2024-02-29T23:52:17", "2024-02-29T23:58:00"),
          ("2024-03-02T00:00:00", "2024-03-03T00:00:00")]


@pytest.mark.parametrize("timeframe", [None, "1min", "5min", "1h", "1D"])
@pytest.mark.parametrize("start, end", RANGES)
def test_read_matches_jax(stores, timeframe, start, end):
    want = jklines.TimeBarReader(stores["jax"]).read(start, end, timeframe)
    reader = klines.TimeBarReader(stores["port"], device="cpu")
    got = reader.read(start, end, timeframe)
    assert len(want) > 0
    _hold(got, want, f"{timeframe} {start}..{end}")
    if timeframe is not None:       # the plain version: the same frame
        plain = klines.TimeBarReader(stores["port"], device="cpu", plain=True)
        for k, v in plain.read(start, end, timeframe).items():
            assert_exact(v, got[k], k)


def test_read_ns_and_empty(stores):
    reader = klines.TimeBarReader(stores["port"], device="cpu")
    start = pd.Timestamp("2024-02-29T23:55:00").value
    want = jklines.TimeBarReader(stores["jax"]).read("2024-02-29T23:55:00",
                                                     timeframe="1min")
    _hold(reader.read(start, timeframe="1min"), want)
    first, last = reader.get_time_range()
    jf, jl = jklines.TimeBarReader(stores["jax"]).get_time_range()
    assert (first, last) == (jf.value, jl.value)
    assert reader.list_keys() == jklines.TimeBarReader(stores["jax"]).list_keys()
    assert len(jklines.TimeBarReader(stores["jax"]).read("2099-01-01", "2099-01-02")) == 0
    for tf in (None, "1min"):
        empty = reader.read("2099-01-01", "2099-01-02", tf)
        assert list(empty) == ["timestamp", *klines.KLINE_COLS]
        assert all(v.shape == (0,) for v in empty.values())


def _frame_case(case, n=600, seed=0):
    """A 1-second frame (numpy columns, int64 ns) for the resample alone."""
    r = np.random.default_rng(seed)
    ts = pd.Timestamp("2024-01-01T23:30:00").value + np.sort(
        r.choice(3600, n, replace=False)).astype(np.int64) * 10**9
    close = np.round(100 + np.cumsum(r.normal(0, 0.1, n)), 2)
    cols = {"open": close + 0.01, "high": close + 0.05, "low": close - 0.05,
            "close": close, "volume": r.lognormal(0, 1, n).astype(np.float32),
            "trades": r.integers(0, 9, n).astype(np.int64),
            "median_trade_size": np.round(r.lognormal(-2, 1, n), 3),
            "vwap": close + 0.002}
    if case == "nans":     # NaNs inside groups, a group of NaN opens, NaN sizes
        for c in ("open", "high", "low", "close", "vwap", "volume", "median_trade_size"):
            cols[c][r.random(n) < 0.2] = np.nan
        late = ts >= pd.Timestamp("2024-01-02T00:10:00").value
        late &= ts < pd.Timestamp("2024-01-02T00:11:00").value
        cols["open"][late] = np.nan
    elif case == "ties":   # few sizes, many ties; zero-count seconds
        cols["median_trade_size"] = r.choice([0.1, 0.2, 0.2000001, 0.5], n)
        cols["trades"][r.random(n) < 0.3] = 0
    elif case == "zero_count_group":   # a minute without a trade: its median is NaN
        m = (ts >= pd.Timestamp("2024-01-01T23:40:00").value)
        m &= ts < pd.Timestamp("2024-01-01T23:41:00").value
        cols["trades"][m] = 0
    return ts, cols


@pytest.mark.parametrize("case", ["clean", "nans", "ties", "zero_count_group"])
@pytest.mark.parametrize("timeframe", ["1s", "7s", "1min", "1.5min", "1h", "1h30min",
                                       "1D", "2D"])
def test_resample_matches_jax(case, timeframe):
    ts, cols = _frame_case(case)
    df = pd.DataFrame(cols, index=pd.to_datetime(ts, unit="ns"))
    want = jklines.TimeBarReader._resample(df, timeframe)
    frame = {"timestamp": torch.from_numpy(ts),
             **{k: torch.from_numpy(v) for k, v in cols.items()}}
    got = klines.resample(frame, timeframe)
    _hold(got, want, f"{case} {timeframe}")
    plain = klines.resample(frame, timeframe, plain=True)
    for k, v in plain.items():
        assert_exact(v, got[k], k)
    if case == "nans" and timeframe == "1min":
        assert len(got["open"]) == len(want) < len(np.unique(ts // (60 * 10**9)))
    if case == "zero_count_group" and timeframe == "1min":
        assert np.isnan(got["median_trade_size"].numpy()).sum() == 1


@pytest.mark.parametrize("case", ["clean", "nans", "ties", "zero_count_group"])
@pytest.mark.parametrize("timeframe", ["7s", "1min", "1h", "1D"])
def test_chip_smoke_oracle_matches_jax(case, timeframe):
    """``chip_smoke.resample_numpy``, the oracle phase 13 holds the card's
    resample to where there is no pandas, equals the JAX ``_resample``."""
    from chip_smoke import resample_numpy
    ts, cols = _frame_case(case)
    want = jklines.TimeBarReader._resample(
        pd.DataFrame(cols, index=pd.to_datetime(ts, unit="ns")), timeframe)
    got = resample_numpy(ts, cols, klines.parse_timeframe(timeframe))
    _hold({k: torch.from_numpy(v) for k, v in got.items()}, want, f"oracle {case} {timeframe}")


def test_dominant_second_drives_the_median(stores):
    reader = klines.TimeBarReader(stores["port"], device="cpu")
    sec = reader.read()
    i = int(torch.argmax(sec["trades"]))
    five = reader.read(timeframe="5min")
    k = int(torch.searchsorted(five["timestamp"], sec["timestamp"][i], right=True)) - 1
    assert int(sec["trades"][i]) * 2 > int(five["trades"][k])
    assert five["median_trade_size"][k] == sec["median_trade_size"][i].to(torch.float32)


ALIASES = ["ns", "NS", "Ns", "us", "US", "ms", "MS", "Ms", "s", "S", "min", "Min", "MIN",
           "h", "H", "d", "D", "1s", "5min", "15min", "1h", "1D", "2D", "7D", "W", "1W", "M",
           "ME", "Y", "YE", "Q", "B", "BH", "T", "3T", "L", "U", "N", "5S", "1H", "1.5h",
           "1.5min", "0.5s", ".5s", "1.s", "0.3ms", "0.1us", "1.1ns", "0.5ns", "1.333333h",
           "+1min", " 1min", "1 min", "1min ", "\n1min", "01min", "1h30min", "1h 30min",
           "1D2h", "h30min", "30s1min", "2h-30min", "+ 1min", "1,5h", "1e3s", "1_000s",
           "min1", "D1", "1D1", "", "1", "sec", "hour", "day", "10000D", "106751D",
           "106752D", "999999999999ns", "1.5e2s", "1.5.5s", "1..5s", "."]


@pytest.mark.parametrize("alias", ALIASES)
def test_timeframes_as_pandas_floor_reads_them(alias):
    """The aliases pandas' ``DatetimeIndex.floor`` accepts, with their lengths,
    and those it refuses; lengths of zero or less, which floor accepts
    without grouping, are refused here and left out of the list."""
    idx = pd.DatetimeIndex(np.array([1_700_000_000_123_456_789], "datetime64[ns]"))
    try:
        floored = idx.floor(alias)
        want = pd.tseries.frequencies.to_offset(alias).nanos
    except ValueError:
        with pytest.raises(ValueError):
            klines.parse_timeframe(alias)
        return
    f = klines.parse_timeframe(alias)
    assert f == want
    assert (idx.asi8[0] // f) * f == floored.asi8[0]


@pytest.mark.parametrize("alias", ["0min", "-1min", "0s", "-1d1h", 60])
def test_nonpositive_timeframes_raise(alias):
    with pytest.raises(ValueError):
        klines.parse_timeframe(alias)


def test_import_without_h5py():
    """``build_klines`` and ``resample`` need no h5py; the store's functions
    raise ImportError where it does not import."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['h5py'] = None\n"
            "import numpy as np, torch\n"
            "from finmlkit_tpu_torch.data import klines, store\n"
            "from finmlkit_tpu_torch.bar.data_model import TradesData\n"
            "ts = 1_700_000_000_000_000_000 + np.arange(50, dtype=np.int64) * 300_000_000\n"
            "t = TradesData(ts, np.full(50, 100.0) + np.arange(50) * 0.1,\n"
            "               np.ones(50, np.float32), timestamp_unit='ns')\n"
            "bars = klines.build_klines(t, device='cpu')\n"
            "out = klines.resample(bars, '5s')\n"
            "assert int(out['trades'].sum()) == int(bars['trades'].sum()) == 49, out\n"
            "try:\n"
            "    store.load_trades_h5('x.h5')\n"
            "except ImportError as e:\n"
            "    assert 'h5py' in str(e)\n"
            "else:\n"
            "    raise SystemExit('no ImportError')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
