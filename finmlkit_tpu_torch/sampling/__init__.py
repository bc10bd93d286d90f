"""Event sampling filters."""
from .filters import cusum_filter, z_score_peak_filter

__all__ = ["cusum_filter", "z_score_peak_filter"]
