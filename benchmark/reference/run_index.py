"""Reference tick run bars with an EMA threshold: trade 0 opens the first
bar, the checks start at trade 1, and a bar closes at the first trade where
its count of buys or its count of sells (trade 0 left out) reaches theta =
E[T] * E[rate]. At each close, T the bar's length in trades from the last
close (or trade 0) and the statistic the larger count there, ``E[T] <- (1 -
alpha_ticks) E[T] + alpha_ticks T`` and ``E[rate] <- (1 - alpha_rate)
E[rate] + alpha_rate stat / max(T, 1)``, in the configuration's float64 on
the host, and both counts start again at zero. The counts only grow within a
bar, so the close after close ``c`` is the nearer of the first trades whose
prefix of buys, or of sells, reaches its value at ``c`` plus
``ceil(theta)`` (``np.searchsorted``)."""
import math

import numpy as np
import torch


def closes(side: np.ndarray, e_t, e_r, a_t, a_r, dtype=np.float64) -> list:
    """The close indices, the anchor 0 first; the EMA state and its updates
    in ``dtype``."""
    buys = np.cumsum(side == 1, dtype=np.int64)
    sells = np.cumsum(side == -1, dtype=np.int64)
    one = dtype(1.0)
    e_t, e_r, a_t, a_r = dtype(e_t), dtype(e_r), dtype(a_t), dtype(a_r)
    n, out, c = len(side), [0], 0
    while True:
        k = math.ceil(float(e_t * e_r))
        jb = int(np.searchsorted(buys, buys[c] + k, side="left"))
        js = int(np.searchsorted(sells, sells[c] + k, side="left"))
        j = max(min(jb, js), c + 1)
        if j > n - 1:
            return out
        stat = dtype(max(buys[j] - buys[c], sells[j] - sells[c]))
        t_bar = dtype(j - c)
        rate = stat / max(t_bar, one)
        e_t = (one - a_t) * e_t + a_t * t_bar
        e_r = (one - a_r) * e_r + a_r * rate
        out.append(j)
        c = j


def run(r, p):
    if p["mode"] != "tick":
        raise ValueError(f"the reference holds tick run bars, not {p['mode']!r}")
    dtype = np.float32 if r.prec.f == torch.float32 else np.float64
    ci = closes(r.side.cpu().numpy(), p["expected_ticks_init"], p["expected_rate_init"],
                p["alpha_ticks"], p["alpha_rate"], dtype)
    r.out["run.ci"] = torch.tensor(ci, dtype=torch.int64, device=r.device)
