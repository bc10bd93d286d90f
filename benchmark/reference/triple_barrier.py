"""Reference triple-barrier labels (AFML ch. 3) of the events on the bars:
each event's path runs over the bars after it up to its vertical barrier,
the last bar at most ``vertical_s`` after it; its return at a bar is the
log close there less the log close at the event. The first bar whose
return reaches ``target * barriers[1]`` or ``-target * barriers[0]``
(at least ``min_close_time_s`` after the event) is the touch, else the
vertical barrier. Label: the sign of the return at the touch (0 counts as
+1). The return-to-barrier ratio: over the path up to the touch, the
largest ``ret / upper`` of positive returns (``mu``) and ``ret / lower`` of
negative ones (``ml``); at a vertical touch ``mu / (1 + ml)`` for a positive
return and ``ml / (1 + mu)`` otherwise, at most 1, and 1 at a horizontal
one. An event with no bar after it within the barrier is skipped: label 0,
its own bar as touch, NaN return and ratio."""
import torch


def run(r, p):
    f, dev = r.prec.f, r.device
    ts = r.aux["bar_ts"]
    logc = torch.log(r.out["ohlcv.close"].to(f))
    ev = r.out["events"]
    n = ts.shape[0]
    target = float(p["target"])
    upper = target * float(p["barriers"][1])
    lower = -target * float(p["barriers"][0])
    t0 = ts[ev]
    limit = (t0.to(torch.float64) + float(p["vertical_s"]) * 1e9).to(torch.int64)
    t1 = torch.searchsorted(ts, limit, right=True) - 1
    width = max(int((t1 - ev).max()), 1)
    j = ev[:, None] + 1 + torch.arange(width, device=dev)
    on_path = j <= t1[:, None]
    jc = j.clamp(max=n - 1)
    ret = logc[jc] - logc[ev][:, None]
    late = (ts[jc] - t0[:, None]).to(torch.float64) >= float(p["min_close_time_s"]) * 1e9
    hit = on_path & late & ((ret >= upper) | (ret <= lower))
    any_hit = hit.any(1)
    first = torch.where(any_hit, hit.to(torch.int8).argmax(1), width)
    touch = torch.where(any_hit, ev + 1 + first, t1)
    upto = on_path & late & (torch.arange(width, device=dev)[None, :] <= first[:, None])
    zero = torch.zeros((), dtype=f, device=dev)
    mu = torch.where(upto & (ret > 0), ret / upper, zero).amax(1).clamp(min=0)
    ml = torch.where(upto & (ret < 0), ret / lower, zero).amax(1).clamp(min=0)
    skipped = t1 <= ev
    tr = logc[touch] - logc[ev]
    ok = ~skipped & ((ts[touch] - t0).to(torch.float64) >= float(p["min_close_time_s"]) * 1e9)
    tr = torch.where(ok, tr, zero)
    label = torch.where(tr < 0, -1, 1).to(torch.int8)
    ratio = torch.where(tr > 0, mu / (1 + ml), ml / (1 + mu))
    ratio = torch.where(touch == t1, ratio.clamp(max=1.0), torch.ones_like(ratio))
    nan = torch.full_like(ratio, float("nan"))
    r.out["labels.label"] = torch.where(skipped, 0, label).to(torch.int8)
    r.out["labels.touch"] = torch.where(skipped, ev, touch)
    r.out["labels.ret"] = r.prec.out64(torch.where(skipped, nan, tr))
    r.out["labels.max_rb_ratio"] = r.prec.out64(torch.where(skipped, nan, ratio))
