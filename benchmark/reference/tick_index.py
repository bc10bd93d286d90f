"""Reference tick bars: trade 0 opens the first bar and counts in it, and a
bar closes at the trade that makes its count ``ticks``, the count then
starting again at zero; so the closes are trades ``ticks - 1``, ``2 ticks -
1``, ... (a close at trade 1 at the earliest), the trades after the last
close in no bar."""
import torch


def run(r, p):
    t = int(p["ticks"])
    first, step = max(t - 1, 1), max(t, 1)
    ci = torch.cat([torch.zeros(1, dtype=torch.int64, device=r.device),
                    torch.arange(first, r.n, step, dtype=torch.int64, device=r.device)])
    r.out["tick.ci"] = ci
