"""The stages' byte counts against counts worked by hand, and against the
reference's own output columns."""
import pytest

import harness
from refbase import Precision, RefRun

PRODUCTS = harness.module(harness.BENCH_DIR, "bytecounts", "products")
FOOTPRINTS = harness.module(harness.BENCH_DIR, "bytecounts", "footprints")


@pytest.mark.parametrize("n, nb, want", [
    (10, 3, 10 * (4 + 8 + 1 + 4) + 4 * 8 + 3 * (6 * 8 + 5 * 8 + 11 * 4)),   # 598
    (1, 1, 17 + 16 + 132),
    (39_171_929, 45_705, 39_171_929 * 17 + 45_706 * 8 + 45_705 * 132),
])
def test_products_bytes(n, nb, want):
    assert PRODUCTS.bytes_of(n, nb) == want


@pytest.mark.parametrize("n, nb, width, want", [
    # trades 9 B, close indices 8 B, lows and highs 16 B a bar, cells 18 B, bars 34 B
    (10, 3, 8, 90 + 32 + 48 + 3 * 8 * 18 + 3 * 34),    # 704
    (5, 1, 16, 45 + 16 + 16 + 16 * 18 + 34),
])
def test_footprint_bytes(n, nb, width, want):
    assert FOOTPRINTS.bytes_of(n, nb, width) == want


def test_counts_follow_the_stated_columns():
    """Each count's per-bar and per-cell bytes are the element sizes of the
    stage's outputs, as the reference states them."""
    import month
    cell = harness.Cell("infobars.dollar-footprint", harness.load_json(harness.SPEC))
    m = month.synthesize(cell.config["assumed"]["month"], 3, "cpu", 20_000)
    thr = month.thresholds(m, cell.config["settings"])
    r = RefRun(m, cell.config["grid"], thr, "cpu", Precision())
    for step, _, _, params in cell.steps:
        cell.reference(step).run(r, params)
    nb = r.out["ci"].shape[0] - 1
    L = r.out["footprints.buy_volumes"].shape[1]
    per_bar = sum(v.element_size() for k, v in r.out.items()
                  if k.startswith(("ohlcv.", "directional.")))
    assert per_bar == PRODUCTS.BAR_OUT
    cells = sum(v.element_size() for k, v in r.out.items()
                if k.startswith("footprints.") and v.dim() == 2)
    bars = sum(v.element_size() for k, v in r.out.items()
               if k.startswith("footprints.") and v.dim() == 1)
    assert cells == FOOTPRINTS.CELL_OUT and bars == FOOTPRINTS.BAR_OUT
    assert r.out["footprints.buy_volumes"].shape == (nb, L)
