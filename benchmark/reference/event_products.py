"""Reference bar products of one kind of event bars (``params.bars``): the
reference step ``bar_products`` on ``<kind>.ci``, its outputs renamed
``ohlcv.<kind>.<col>`` and ``directional.<kind>.<col>``."""
import copy
from pathlib import Path

import harness

_PRODUCTS = harness.module(Path(__file__).resolve().parent.parent, "reference",
                           "bar_products")


def run(r, p):
    kind = p["bars"]
    one = copy.copy(r)
    one.out, one.aux = {"ci": r.out[f"{kind}.ci"]}, {}
    _PRODUCTS.run(one, p)
    for name, v in one.out.items():
        group, _, col = name.partition(".")
        if col:
            r.out[f"{group}.{kind}.{col}"] = v
