"""Bar products: ``bar/fused.py bar_products_final`` with the bar scan and
the median engine that the bar kits take by default (read from
``bar/kit.py``'s signature, so a changed default is what runs)."""
import inspect

from finmlkit_tpu_torch.bar import kit
from finmlkit_tpu_torch.bar.fused import bar_products_final, bar_scan, median_engine

_KIT = inspect.signature(kit.BarBuilderBase.__init__).parameters
SCAN, MEDIANS = _KIT["scan"].default, _KIT["medians"].default


def run(ctx, p):
    tr = ctx.trades
    ohlcv, directional = bar_products_final(
        tr.ticks, tr.units, ctx.out["ci"], tr.sides, tick_size=tr.tick_size,
        amount_scale=tr.amount_scale, amounts_f32=tr.amounts, scan=bar_scan(SCAN),
        medians=median_engine(MEDIANS))
    for k, v in ohlcv.items():
        ctx.out[f"ohlcv.{k}"] = v
    for k, v in directional.items():
        ctx.out[f"directional.{k}"] = v
    ctx.aux["ohlcv"] = ohlcv
