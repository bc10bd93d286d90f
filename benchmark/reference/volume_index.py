"""Reference volume bars in integer units: the in-bar sum of the units starts
with trade 0's, the checks start at trade 1, a bar closes at the first trade
where the sum reaches the threshold in units (the integer ceiling of the
threshold over the grid's unit, in float64), and the sum starts again at
zero. Bar by bar on the host: the next close is the first trade whose
inclusive prefix of the units reaches the prefix at the last close plus the
threshold (``np.searchsorted``)."""
import math

import numpy as np
import torch


def closes(units: np.ndarray, thr: int) -> list:
    """The close indices, the anchor 0 first, of int64 ``units`` at ``thr``."""
    c = np.cumsum(units, dtype=np.int64)
    n, out, last, base = len(units), [0], 0, 0
    while True:
        j = max(int(np.searchsorted(c, base + thr, side="left")), last + 1)
        if j > n - 1:
            return out
        out.append(j)
        last, base = j, int(c[j])


def run(r, p):
    thr = math.ceil(float(p["threshold"]) / r.unit)
    ci = closes(r.units.cpu().numpy(), thr)
    r.out["volume.ci"] = torch.tensor(ci, dtype=torch.int64, device=r.device)
