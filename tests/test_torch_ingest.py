"""The port's store ingest for the ranks of a time mesh
(``parallel/ingest.py``) on the CPU: the month and row plans against the JAX
package's, the parallel month load against the JAX one on a store of three
months (written by the port's ``data/store.py``), the ``ValueError`` on a
column that some months lack, and ``load_store_to_mesh`` on 3 ranks over gloo
(one spawn): each rank's rows, and the time bars' products on the mesh
against the same months loaded on one device (``parallel/dryrun.py``'s
ingest flow). Needs h5py.
"""
import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
jax = pytest.importorskip("jax")

from finmlkit_tpu.parallel import ingest as jingest  # noqa: E402
from finmlkit_tpu_torch.bar.data_model import TradesData  # noqa: E402
from finmlkit_tpu_torch.data.store import load_trades_h5, save_trades_h5  # noqa: E402
from finmlkit_tpu_torch.parallel import dryrun, ingest  # noqa: E402
from finmlkit_tpu_torch.parallel.mesh import spawn_mesh  # noqa: E402

N_MONTH = 2_001


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ingest") / "trades.h5")
    months = dryrun._write_store(path, N_MONTH, 3)
    return path, months


@pytest.fixture(scope="module")
def ranks(store):
    path, months = store
    return spawn_mesh(dryrun._ingest_rank, 3, args=(path, months), device="cpu",
                      timeout=120)


@pytest.mark.parametrize("n_proc", [1, 2, 3, 5])
@pytest.mark.parametrize("months", [["2024-03", "2024-01", "2024-02", "2024-04"],
                                    ["2023-12"], [f"2024-{m:02d}" for m in range(1, 13)]])
def test_month_plan_matches_jax(months, n_proc):
    assert ingest.month_plan(months, n_proc) == jingest.month_plan(months, n_proc)


@pytest.mark.parametrize("n_padded", [None, 224, 300])
@pytest.mark.parametrize("n_proc", [1, 2, 3, 4, 7])
def test_row_plan_matches_jax(n_proc, n_padded):
    counts = {"2024-01": 100, "2024-02": 50, "2024-03": 70}
    assert ingest.row_plan(counts, n_proc, n_padded) == \
        jingest.row_plan(counts, n_proc, n_padded)


@pytest.mark.parametrize("workers", [1, 2])
def test_load_months_matches_jax(store, workers):
    path, months = store
    got = ingest.load_months_parallel(path, months[1:], max_workers=workers)
    want = jingest.load_months_parallel(path, months[1:], max_workers=1)
    assert sorted(got) == sorted(want) == ["amount", "price", "side", "timestamp"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert ingest._month_counts(path, months) == jingest._month_counts(path, months)


def test_a_column_missing_in_some_months_raises(tmp_path):
    path = str(tmp_path / "gap.h5")
    for k, key in enumerate(("2024-01", "2024-02")):
        ts, price, amount, side = dryrun.synth_trades(50, k)
        from finmlkit_tpu_torch.data.store import month_bounds
        ts = month_bounds(key)[0] + np.arange(50, dtype=np.int64) * 10**9
        save_trades_h5(TradesData(ts, price, amount, side=side if k == 0 else None), path,
                       month_key=key)
    with pytest.raises(ValueError, match="'side' present in months"):
        ingest.load_months_parallel(path, ["2024-01", "2024-02"], max_workers=1)


def test_ranks_load_their_rows(store, ranks):
    path, months = store
    total = 3 * N_MONTH
    _, spans = ingest.row_plan({m: N_MONTH for m in months}, 3)
    assert [r["rows"] for r in ranks] == [hi - lo for lo, hi in spans]
    assert all(r["total"] == total for r in ranks)
    assert len(load_trades_h5(path).data["timestamp"]) == total


def test_mesh_products_match_one_device(ranks):
    for r in ranks:
        assert r["bad"] == [] and r["bars"] > 100
