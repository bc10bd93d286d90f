"""Trade utilities (numpy, on the host).

Counterpart of ``finmlkit_tpu/bar/utils.py``; only the tick-size estimate that
quantization needs is ported so far.
"""
import numpy as np

__all__ = ["comp_price_tick_size"]


def comp_price_tick_size(prices: np.ndarray) -> float:
    """Estimate the smallest price increment via GCD of scaled unique diffs.

    Same arithmetic as ``finmlkit_tpu.bar.utils.comp_price_tick_size``.
    """
    if len(prices) == 0:
        raise ValueError("Empty prices array")
    sample = np.round(prices[: min(10000, len(prices))], decimals=12)
    uniq = np.unique(sample)
    if len(uniq) <= 1:
        return 0.0
    diffs = np.diff(uniq)
    pos = diffs[diffs > 0]
    scale = 10.0 ** (-np.floor(np.log10(np.min(pos))))
    int_px = np.round(uniq * scale).astype(np.int64)
    int_diffs = np.diff(int_px)
    tick_int = int(np.gcd.reduce(int_diffs[int_diffs > 0])) if np.any(int_diffs > 0) else 0
    return tick_int / scale
