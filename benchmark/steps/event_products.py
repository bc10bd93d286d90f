"""Bar products of one kind of event bars (``params.bars``): the step
``bar_products`` called on ``<kind>.ci``, its outputs renamed
``ohlcv.<kind>.<col>`` and ``directional.<kind>.<col>`` so that the five
sets of a pass keep their own names and ``judge.py`` their groups."""
from pathlib import Path
from types import SimpleNamespace

import harness

_PRODUCTS = harness.module(Path(__file__).resolve().parent.parent, "steps", "bar_products")


def run(ctx, p):
    kind = p["bars"]
    one = SimpleNamespace(trades=ctx.trades, out={"ci": ctx.out[f"{kind}.ci"]}, aux={})
    _PRODUCTS.run(one, p)
    for name, v in one.out.items():
        group, _, col = name.partition(".")
        if col:
            ctx.out[f"{group}.{kind}.{col}"] = v
