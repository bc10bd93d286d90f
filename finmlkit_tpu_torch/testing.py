"""Comparisons that the parity tests and ``chip_smoke.py`` share.

Each raises ``AssertionError`` with the largest deviation when the two sides
differ beyond what the comparison allows.
"""
import numpy as np
import torch

__all__ = ["to_numpy", "assert_exact", "assert_close", "assert_window_close"]


def to_numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_exact(got, want, what: str = "") -> None:
    """Equal values of equal dtype; floats compare by bits, except that any
    NaN equals any NaN (the sign of a 0/0 NaN depends on the device)."""
    g, w = to_numpy(got), to_numpy(want)
    if g.shape != w.shape or g.dtype != w.dtype:
        raise AssertionError(f"{what}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}")
    if g.dtype.kind == "f":
        nan_g, nan_w = np.isnan(g), np.isnan(w)
        if not np.array_equal(nan_g, nan_w):
            raise AssertionError(f"{what}: NaN at different positions")
        ib = {2: np.int16, 4: np.int32, 8: np.int64}[g.dtype.itemsize]
        g, w = g[~nan_g].view(ib), w[~nan_w].view(ib)
    bad = np.flatnonzero(g != w)
    if bad.size:
        i = bad[0]
        raise AssertionError(f"{what}: {bad.size} of {g.size} differ, first at "
                             f"{i}: {g.reshape(-1)[i]!r} vs {w.reshape(-1)[i]!r}")


def assert_close(got, want, rtol: float, atol: float = 0.0, what: str = "") -> float:
    """|got - want| <= atol + rtol * |want|, NaN where both are NaN.
    Returns the largest absolute deviation."""
    g = to_numpy(got).astype(np.float64)
    w = to_numpy(want).astype(np.float64)
    if g.shape != w.shape:
        raise AssertionError(f"{what}: shape {g.shape} vs {w.shape}")
    nan_g, nan_w = np.isnan(g), np.isnan(w)
    if not np.array_equal(nan_g, nan_w):
        raise AssertionError(f"{what}: NaN at different positions")
    d = np.abs(g[~nan_g] - w[~nan_w])
    lim = atol + rtol * np.abs(w[~nan_w])
    if np.any(d > lim):
        i = int(np.argmax(d - lim))
        raise AssertionError(f"{what}: |diff| {d[i]!r} above {lim[i]!r} "
                             f"(rtol {rtol}, atol {atol})")
    return float(d.max()) if d.size else 0.0


def assert_window_close(got, want, scale: float, rtol: float, what: str = "") -> float:
    """Values that are differences of two prefix sums of magnitude up to
    ``scale`` (window sums, returns as differences of log prices): their
    rounding error scales with the prefix, so the bound is
    ``rtol * (|want| + scale)``."""
    return assert_close(got, want, rtol=rtol, atol=rtol * float(scale), what=what)


def adversarial_trades(n: int, seed: int, first: int = -1, long_bar: int = 0,
                       mean_bar: int = 600):
    """Quantized trades and close indices that hit the bar kernel's edge
    cases: side-0 trades, units above 2^31, tied amounts, empty bars
    (repeated close indices), single-trade bars, the open anchor ``first``
    (-1, or a trade index when earlier trades lie outside every bar), one bar
    of ``long_bar`` trades, and trailing trades after the last bar.

    Returns numpy ``(ticks int32, units int64, sides int8, amounts float32,
    ci int64)``.
    """
    g = np.random.default_rng(seed)
    ticks = (1_070_000 + np.cumsum(g.integers(-3, 4, n))).astype(np.int32)
    units = g.integers(1, 10**7, n).astype(np.int64)
    units[::7] = g.integers(2**31, 2**40, len(units[::7]))
    units[::11] = units[3]
    sides = g.choice(np.array([-1, 0, 1], np.int8), n, p=[0.45, 0.1, 0.45])
    amounts = (units.astype(np.float64) * 1e-8).astype(np.float32)
    ci = [first]
    pos = first
    if long_bar:
        pos += long_bar
        ci.append(pos)
    end = n - 1 - min(5, n // 4)
    while pos < end:
        u = g.random()
        if u < 0.1:
            pos += 1            # single-trade bar
        elif u > 0.95:
            pass                # empty bar
        else:
            pos += int(g.geometric(1.0 / mean_bar))
        pos = min(pos, end)
        ci.append(pos)
    return ticks, units, sides, amounts, np.asarray(ci, np.int64)
