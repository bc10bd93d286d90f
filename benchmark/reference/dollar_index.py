"""Reference dollar bars in integer dollar units: each trade's dollars
``(ticks * units) >> 6`` (the unit of ``2^6`` tick-units keeps a month inside
int64), their running total ``c``, and bar m's close the first trade from
trade 1 on at which ``c`` reaches ``ceil(m * thr)`` (the threshold in those
units, in float64), at least one trade after bar m - 1's close. Bar 0 opens
after trade 0; trades after the last close belong to no bar."""
import numpy as np
import torch


def run(r, p):
    d = (r.ticks * r.units) >> 6
    c = torch.cumsum(d, 0)
    thr = float(r.thr["dollar"]) / (r.tick * r.unit) / 64.0
    total = int(c[-1])
    m = np.arange(1, int(total / thr) + 2, dtype=np.float64)
    targets = torch.from_numpy(np.ceil(m * thr).astype(np.int64)).to(r.device)
    first = torch.searchsorted(c, targets).cpu().numpy()
    closes, prev, n = [0], 0, r.n
    for f in first.tolist():
        b = max(f, prev + 1, 1)
        if b > n - 1:
            break
        closes.append(b)
        prev = b
    ci = torch.tensor(closes, dtype=torch.int64, device=r.device)
    r.out["ci"], r.out["close_ts"] = ci, r.ts[ci]
    r.aux["bar_ts"] = r.ts[ci[1:]]
