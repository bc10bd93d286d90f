"""The month of trades a cell runs on, drawn from the seed.

The draws are those of ``bench.py:78-86`` (the repository's synthetic
BTCUSDT month), written in PyTorch: exponential gaps, a log-normal price walk
rounded to the price grid, log-normal amounts rounded to their decimals and
sides at even odds. Every parameter comes from the configuration's
``assumed.month``. The random numbers are drawn on ``device`` from one
``torch.Generator`` seeded with the run's seed, so one seed gives the same
month on every card; the price walk's float64 prefix sum runs on the host
(numpy), whose order of additions is fixed.

Also here: the thresholds that a cell derives from the month (the dollar
bar's size), computed once from the raw columns and handed to both the
program and the reference.
"""
import numpy as np
import torch


class Month:
    """The raw columns of a month, as host numpy arrays: int64 ns
    timestamps, float64 prices, float32 amounts and int8 sides (+1 a buy,
    -1 a sell)."""

    def __init__(self, ts, price, amount, side):
        self.ts, self.price, self.amount, self.side = ts, price, amount, side

    @property
    def n(self) -> int:
        return len(self.ts)


def synthesize(draws: dict, seed: int, device, n_trades: int | None = None) -> Month:
    """The month of ``draws`` (the configuration's ``assumed.month``) for
    ``seed``; ``n_trades`` overrides its size (the CPU tests)."""
    n = int(draws["n_trades"] if n_trades is None else n_trades)
    f64 = torch.float64
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    gaps = torch.empty(n, dtype=f64, device=device).exponential_(
        1.0 / draws["mean_gap_ms"], generator=g)
    dt = (gaps * 1e6).to(torch.int64)
    del gaps
    ts = int(draws["start_ns"]) + torch.cumsum(dt, 0)
    del dt
    steps = torch.randn(n, dtype=f64, device=device, generator=g) * draws["log_step_sigma"]
    amount = torch.empty(n, dtype=f64, device=device).log_normal_(
        draws["amount_log_mean"], draws["amount_log_sigma"], generator=g)
    amount = torch.clamp(torch.round(amount, decimals=draws["amount_decimals"]),
                         min=draws["amount_min"]).to(torch.float32)
    side = torch.where(torch.rand(n, device=device, generator=g) < draws["buy_share"],
                       1, -1).to(torch.int8)
    walk = np.cumsum(steps.cpu().numpy())
    del steps
    price = np.round(draws["price0"] * np.exp(walk), draws["price_decimals"])
    return Month(ts.cpu().numpy(), price, amount.cpu().numpy(), side.cpu().numpy())


def dollar_threshold(month: Month, bars: float) -> float:
    """The dollar bar's size: the month's dollar volume over ``bars``
    (``bench.py:784-786``), in float64 on the host."""
    return float((month.price * month.amount).sum()) / float(bars)


def thresholds(month: Month, settings: dict) -> dict:
    """Every threshold the configuration's ``settings`` derive from the
    month, by name."""
    out = {}
    if "dollar_index" in settings:
        out["dollar"] = dollar_threshold(month, settings["dollar_index"]["bars"])
    return out
