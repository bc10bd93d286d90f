"""The feature-kernel catalog: counterpart of
``finmlkit_tpu/feature/kernels``, one module each at the same path.

Array functions over bar series: tensors in, tensors out on the input's
device; numpy inputs go to the ``device`` argument (default ``"cuda"``). All
work in float64. The recurrences run on kernel R (``ops.scan``), the CSW
statistic on kernel W, the rolling and developing volume profiles
(``volume_profile_rolling``, ``volume_profile_developing``, ``VolumePro``) on
kernel G; the windowed reductions are direct window sums in PyTorch.
"""
from .ma import ewma, sma
from .volatility import (
    ewms, ewmst, ewmst_mean0, true_range, realized_vol,
    bollinger_percent_b, parkinson_range, atr, rolling_variance,
    variance_ratio_1_4,
)
from .momentum import roc, rsi_wilder, stoch_k
from .trend import adx
from .misc import comp_lagged_returns, comp_zscore, comp_burst_ratio, pct_change
from .timef import time_cues
from .reversion import vwap_distance
from .volume import (VolumePro, comp_flow_acceleration, volume_profile_developing,
                     volume_profile_rolling, vpin)
from .correlation import rolling_price_volume_correlation
from .structural_break import (cusum_test_rolling, cusum_test_developing,
                               cusum_test_last)

__all__ = [
    "ewma", "sma", "ewms", "ewmst", "ewmst_mean0", "true_range",
    "realized_vol", "bollinger_percent_b", "parkinson_range", "atr",
    "rolling_variance", "variance_ratio_1_4", "roc", "rsi_wilder",
    "stoch_k", "adx", "comp_lagged_returns", "comp_zscore",
    "comp_burst_ratio", "pct_change", "time_cues", "vwap_distance",
    "comp_flow_acceleration", "vpin", "volume_profile_rolling",
    "volume_profile_developing", "VolumePro", "rolling_price_volume_correlation",
    "cusum_test_rolling", "cusum_test_developing", "cusum_test_last",
]
