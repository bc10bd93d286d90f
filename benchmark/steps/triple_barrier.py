"""Triple-barrier labels: ``label/tbm.py triple_barrier`` of the events on
the bars' close times and closes, one target for every event."""
import torch

from finmlkit_tpu_torch.label.tbm import triple_barrier


def run(ctx, p):
    close, ev = ctx.out["ohlcv.close"], ctx.out["events"]
    targets = torch.full((ev.shape[0],), float(p["target"]), dtype=torch.float64,
                         device=close.device)
    label, touch, ret, ratio = triple_barrier(
        ctx.aux["bar_ts"], close, ev, targets, tuple(p["barriers"]), float(p["vertical_s"]),
        min_close_time_sec=float(p["min_close_time_s"]))
    ctx.out.update({"labels.label": label, "labels.touch": touch, "labels.ret": ret,
                    "labels.max_rb_ratio": ratio})
