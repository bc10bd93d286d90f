"""Reference tick imbalance bars at a fixed theta: trade 0 opens the first
bar, the checks start at trade 1, and a bar closes at the first trade where
the in-bar sum of the sides (+1 a buy, -1 a sell, trade 0 left out) reaches
theta in magnitude; the sum then starts again at zero. The sums are
integers, so the walk of the sides' prefix ``P`` closes the bar after close
``c`` at the first later trade with ``|P - P[c]|`` at least ``ceil(theta)``,
found in windows of the walk that double until one holds it."""
import math

import numpy as np
import torch

FIRST_WINDOW = 2048


def closes(side: np.ndarray, k: int) -> list:
    """The close indices, the anchor 0 first, of the sides at ``|sum| >= k``."""
    walk = np.cumsum(side, dtype=np.int64)
    n, out, c, w = len(side), [0], 0, FIRST_WINDOW
    while c + 1 < n:
        seg = np.abs(walk[c + 1:c + 1 + w] - walk[c]) >= k
        j = int(np.argmax(seg))
        if seg[j]:
            c += 1 + j
            out.append(c)
            w = FIRST_WINDOW
        elif c + 1 + w >= n:
            break
        else:
            w *= 2
    return out


def run(r, p):
    if p["mode"] != "tick":
        raise ValueError(f"the reference holds tick imbalance bars, not {p['mode']!r}")
    ci = closes(r.side.cpu().numpy(), math.ceil(float(p["theta"])))
    r.out["imbalance.ci"] = torch.tensor(ci, dtype=torch.int64, device=r.device)
