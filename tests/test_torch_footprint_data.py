"""``FootprintData`` of finmlkit_tpu_torch (``bar/data_model.py``, no pandas)
against the JAX package's ``FootprintData`` on the CPU, both holding the
footprints of one time-bar kit (30-second bars of
``tests/conftest.generate_trades``):
the fields, ``len``, ``price_levels`` and the ragged volume views,
``memory_usage``, slices by position, by time (ISO strings,
``datetime.datetime``, ``numpy.datetime64`` and, through ``.loc``, int64 ns;
both ends kept as pandas' ``.loc`` keeps them), and ``get_columns`` and
``bar/utils.py footprint_to_columns`` against ``get_df`` and
``footprint_to_dataframe``: the same columns, values and row order, the
MultiIndex as ``bar_idx`` and ``bar_datetime_idx`` arrays. Everything exact.
"""
import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from finmlkit_tpu.bar import FootprintData as JFootprintData
from finmlkit_tpu.bar.utils import footprint_to_dataframe
from finmlkit_tpu_torch.bar import FootprintData, kit
from finmlkit_tpu_torch.bar.utils import footprint_to_columns
from finmlkit_tpu_torch.testing import assert_exact
from tests.conftest import generate_trades

TICK = 0.01
FIELDS = ("bar_timestamps", "low_level", "n_levels", "buy_volumes", "sell_volumes",
          "buy_ticks", "sell_ticks", "buy_imbalances", "sell_imbalances",
          "buy_imbalances_sum", "sell_imbalances_sum", "cot_price_levels",
          "imb_max_run_signed", "vp_skew", "vp_gini")


@pytest.fixture(scope="module")
def pair():
    """The port's container of one kit's footprints, and the JAX container
    of the same arrays (the containers are under test, not the grids:
    ``tests/test_torch_kit.py`` holds those)."""
    ts, px, amt, side = generate_trades(n=5000, seed=4)
    fp = kit.TimeBarKit(ts, px, amt, side, 30.0, device="cpu").build_footprints(TICK)
    jfp = JFootprintData(bar_timestamps=fp["timestamp"].numpy(), price_tick=TICK,
                         **{k: fp[k].numpy() for k in FIELDS[1:]})
    return jfp, FootprintData.from_dict(fp, TICK)


def _hold(got, want, what=""):
    assert len(got) == len(want), what
    assert got.price_tick == want.price_tick
    for k in FIELDS:
        assert_exact(getattr(got, k), np.asarray(getattr(want, k)), f"{what} {k}")


def test_fields_and_views(pair):
    jfp, fp = pair
    assert len(fp) > 20
    _hold(fp, jfp)
    for a, b in zip(fp.price_levels, jfp.price_levels):
        assert_exact(a, b, "price_levels")
    for view in ("buy_volumes_ragged", "sell_volumes_ragged"):
        got, want = getattr(fp, view), getattr(jfp, view)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_exact(a, b, view)
    assert fp.memory_usage() == jfp.memory_usage()
    host = FootprintData.from_dict(
        {"timestamp": fp.bar_timestamps.numpy(),
         **{k: getattr(fp, k).numpy() for k in FIELDS[1:]}}, TICK)
    assert host.memory_usage() == fp.memory_usage()


@pytest.mark.parametrize("key", [slice(2, 9), slice(None, 4), slice(-5, None),
                                 slice(0, 0)])
def test_slice_by_position(pair, key):
    jfp, fp = pair
    _hold(fp[key], jfp[key], f"{key}")


def _iso(ns):
    return str(np.datetime64(int(ns), "ns"))


@pytest.mark.parametrize("ends", ["iso", "datetime", "datetime64", "open_start",
                                  "open_stop", "between_bars", "empty"])
def test_slice_by_time(pair, ends):
    jfp, fp = pair
    ts = np.asarray(jfp.bar_timestamps)
    a, b = int(ts[3]), int(ts[11])
    if ends == "between_bars":      # ends that fall between two closes
        a, b = a + 1, b - 1
    if ends == "empty":
        a, b = int(ts[-1]) + 10**9, int(ts[-1]) + 2 * 10**9
    start, stop = _iso(a), _iso(b)
    if ends == "open_start":
        start = None
    if ends == "open_stop":
        stop = None
    want = jfp[slice(start, stop)] if (start, stop) != (None, None) else jfp
    if ends == "datetime":
        key = slice(pd.Timestamp(a).to_pydatetime(), pd.Timestamp(b).to_pydatetime())
        assert isinstance(key.start, datetime.datetime)
    elif ends == "datetime64":
        key = slice(np.datetime64(a, "ns"), np.datetime64(b, "ns"))
    else:
        key = slice(start, stop)
    _hold(fp[key], want, ends)
    # .loc reads ints as int64 ns; the ends stay in
    ns = slice(None if start is None else a, None if stop is None else b)
    _hold(fp.loc[ns], want, f"{ends}, .loc")
    if ends == "iso":
        assert len(fp[key]) == 9


def test_slices_are_checked(pair):
    _, fp = pair
    with pytest.raises(TypeError):
        fp[3]
    with pytest.raises(TypeError):
        fp.loc[3]


def _hold_columns(got, df):
    cols = ["price_level", "sell_ticks", "buy_ticks", "sell_volume", "buy_volume",
            "sell_imbalance", "buy_imbalance"]
    assert list(df.columns) == cols
    assert list(got) == cols + ["bar_idx", "bar_datetime_idx"]
    for c in cols:
        assert_exact(got[c], df[c].values, c)
    assert_exact(got["bar_idx"], df.index.get_level_values(0).values.astype(np.int64),
                 "bar_idx")
    assert_exact(got["bar_datetime_idx"],
                 df.index.get_level_values(1).values.astype("datetime64[ns]")
                 .view(np.int64), "bar_datetime_idx")


def test_get_columns_matches_get_df(pair):
    jfp, fp = pair
    _hold_columns(fp.get_columns(), jfp.get_df())
    _hold_columns(fp[5:9].get_columns(), jfp[5:9].get_df())


def test_footprint_to_columns_matches_footprint_to_dataframe(pair):
    jfp, fp = pair
    args = (jfp.bar_timestamps, jfp.price_levels, jfp.buy_volumes_ragged,
            jfp.sell_volumes_ragged, [jfp.buy_ticks[i, :n] for i, n in
                                      enumerate(jfp.n_levels)],
            [jfp.sell_ticks[i, :n] for i, n in enumerate(jfp.n_levels)],
            [jfp.buy_imbalances[i, :n] for i, n in enumerate(jfp.n_levels)],
            [jfp.sell_imbalances[i, :n] for i, n in enumerate(jfp.n_levels)], TICK)
    got = footprint_to_columns(*args)
    _hold_columns(got, footprint_to_dataframe(*args))
    for k, v in fp.get_columns().items():
        assert_exact(got[k], v, f"{k}: ragged vs dense")
    assert isinstance(fp.buy_volumes, torch.Tensor)
