"""Reference sample weights (AFML ch. 4): the concurrency of each bar (the
events whose span, from the event to its touch, covers it); each event's
average uniqueness, the mean of 1 / concurrency over its span; and its
return attribution, the absolute sum over its span of each bar's log
return over its concurrency (none into bar 0), scaled so that the weights
sum to the number of events."""
import torch


def run(r, p):
    f, dev = r.prec.f, r.device
    ev, touch = r.out["events"], r.out["labels.touch"]
    close = r.out["ohlcv.close"].to(f)
    n = close.shape[0]
    edges = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    edges.index_add_(0, ev, torch.ones_like(ev))
    edges.index_add_(0, touch + 1, -torch.ones_like(touch))
    conc = torch.cumsum(edges, 0)[:n]
    width = int((touch - ev).max()) + 1
    j = ev[:, None] + torch.arange(width, device=dev)
    span = j <= touch[:, None]
    jc = j.clamp(max=n - 1)
    c = conc[jc]
    zero = torch.zeros((), dtype=f, device=dev)
    inv = torch.where(span & (c > 0), 1.0 / c.clamp(min=1).to(f), zero)
    uniq = inv.sum(1) / (touch - ev + 1).to(f)
    lr = torch.cat([torch.full((1,), float("nan"), dtype=f, device=dev),
                    torch.log(close[1:] / close[:-1])])
    contrib = torch.where((conc > 0) & ~torch.isnan(lr), lr / conc.clamp(min=1).to(f), zero)
    w = torch.where(span, contrib[jc], zero).sum(1).abs()
    w = w * (ev.shape[0] / w.sum())
    r.out["weights.uniqueness"] = r.prec.out64(uniq)
    r.out["weights.concurrency"] = conc.to(torch.int16)
    r.out["weights.attribution"] = r.prec.out64(w)
