"""Reference CUSUM events (AFML snippet 2.4) on the bars' closes: log
returns, a positive and a negative running sum each floored at zero, an
event where the negative sum falls below minus the threshold (checked
first) or the positive one rises above it, and only that sum reset. Events
at bars from ``max(n_bars - keep_last, n_bars // 2)`` on are dropped (they
leave the labels no room); with none left, every 97th bar from bar 10 is
an event."""
import numpy as np
import torch


def run(r, p):
    close = r.out["ohlcv.close"].to(r.prec.f).cpu().numpy()
    h = float(p["threshold"])
    rets = np.log(close[1:] / close[:-1]).tolist()
    events, up, down = [], 0.0, 0.0
    for i, x in enumerate(rets, start=1):
        up, down = max(up + x, 0.0), min(down + x, 0.0)
        if down < -h:
            down = 0.0
            events.append(i)
        elif up > h:
            up = 0.0
            events.append(i)
    nb = close.shape[0]
    cut = max(nb - int(p["keep_last"]), nb // 2)
    ev = [e for e in events if e < cut] or list(range(10, cut, 97))
    r.out["events"] = torch.tensor(ev, dtype=torch.int64, device=r.device)
