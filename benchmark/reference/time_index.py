"""Reference time bars: a clock of ``interval_s`` from the floor of the first
trade's time to one step past the ceiling of the last, its points computed in
float64 as upstream's ``np.arange`` computes them and truncated to int64 ns;
close index k is the last trade at or before clock point k."""
import math

import torch


def run(r, p):
    step = float(p["interval_s"]) * 1e9
    first, last = int(r.ts[0]), int(r.ts[-1])
    start = math.floor(first / step) * step
    stop = math.ceil(last / step) * step + step + 1.0
    n_clock = math.ceil((stop - start) / step)
    k = torch.arange(n_clock, dtype=torch.float64, device=r.device)
    clock = (start + k * step).to(torch.int64)
    ci = torch.searchsorted(r.ts, clock, right=True) - 1
    r.out["clock"], r.out["ci"] = clock, ci
    r.aux["bar_ts"] = clock[1:]
