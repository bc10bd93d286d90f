"""Reference CUSUM bars: sigma one constant, so ``lam = max(mult * sigma,
sigma_floor)`` at every trade; the log returns of the month's prices, the
return of trade 0 being 0; from trade 1 on ``s+ = max(0, s+ + r)`` and ``s- =
min(0, s- + r)``, and trade i closes a bar where its timestamp differs from
trade i + 1's (the last trade may close) and ``s+ >= lam`` (then only s+
starts again at zero) or else ``s- <= -lam`` (then only s-). Bar 0 opens
after trade 0, the first valid sigma.

The sums are the configuration's float64 (float32 in the control), taken
in windows from the last close, each from the sums it enters with: over a
window's prefix ``C`` of returns, ``s+ = C - min(-s+_0, running min of C)``
and ``s- = C - max(-s-_0, running max of C)``; the first trade of the window
that may close and crosses is the close, and the next window starts after
it. A window that holds none hands its last sums on, and the next is twice
as long. ``r.aux["cusum_margin"]`` keeps the smallest ``|s+ - lam|`` and
``|s- + lam|`` over the trades that may close, up to each close: how near a
rounding came to moving one."""
import numpy as np
import torch

FIRST_WINDOW = 8192


def closes(rets: np.ndarray, can_close: np.ndarray, lam):
    """``(close indices with the anchor 0 first, smallest margin)``; the sums
    in the dtype of ``rets``."""
    dt = rets.dtype.type
    lam = dt(lam)
    n, out, margin = len(rets), [0], np.inf
    pos, w, sp, sn = 1, FIRST_WINDOW, dt(0.0), dt(0.0)
    while pos < n:
        seg = rets[pos:pos + w]
        c = np.cumsum(seg, dtype=rets.dtype)
        s_pos = c - np.minimum(-sp, np.minimum.accumulate(c))
        s_neg = c - np.maximum(-sn, np.maximum.accumulate(c))
        cc = can_close[pos:pos + w]
        up = s_pos >= lam
        ev = cc & (up | (s_neg <= -lam))
        j = int(np.argmax(ev))
        upto = j + 1 if ev[j] else len(seg)
        near = np.minimum(np.abs(s_pos[:upto] - lam), np.abs(s_neg[:upto] + lam))[cc[:upto]]
        if near.size:
            margin = min(margin, float(near.min()))
        if ev[j]:
            out.append(pos + j)
            sp, sn = (dt(0.0), s_neg[j]) if up[j] else (s_pos[j], dt(0.0))
            pos, w = pos + j + 1, FIRST_WINDOW
        else:
            sp, sn = s_pos[-1], s_neg[-1]
            pos, w = pos + len(seg), 2 * w
    return out, margin


def run(r, p):
    f = r.prec.f
    lam = max(float(p["mult"]) * float(p["sigma"]), float(p["sigma_floor"]))
    lp = torch.log(r.price.to(f))
    rets = torch.cat([torch.zeros(1, dtype=f, device=r.device), lp[1:] - lp[:-1]])
    can_close = torch.cat([r.ts[:-1] != r.ts[1:],
                           torch.ones(1, dtype=torch.bool, device=r.device)])
    ci, margin = closes(rets.cpu().numpy(), can_close.cpu().numpy(), lam)
    r.out["cusum.ci"] = torch.tensor(ci, dtype=torch.int64, device=r.device)
    r.aux["cusum_margin"] = margin
