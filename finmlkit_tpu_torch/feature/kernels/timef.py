"""Time-of-day and day-of-week cyclical cues and session flags.

Counterpart of ``finmlkit_tpu/feature/kernels/timef.py``: elementwise, on
int64 seconds (floor division and modulo, so the flags are exact).
"""
import math

import torch

from ._inputs import device_of, i64

__all__ = ["time_cues"]


def time_cues(timestamps, *, device="cuda"):
    """Returns (sin_td, cos_td, sin_dw, cos_dw, asia, eu, us, trans, top_hr)
    for int64 nanosecond timestamps."""
    ts = torch.div(i64(timestamps, device_of(device, timestamps)), 1_000_000_000,
                   rounding_mode="floor")
    twopi = 2.0 * math.pi

    sec_in_day = torch.remainder(ts, 86400)
    phase = twopi * (sec_in_day.to(torch.float64) / 86400.0)
    day_week = torch.remainder(torch.div(ts, 86400, rounding_mode="floor") + 3, 7)
    phase_w = twopi * (day_week.to(torch.float64) / 7.0)  # the epoch was a Thursday

    hour = torch.div(sec_in_day, 3600, rounding_mode="floor")
    asia = (hour >= 0) & (hour < 8)
    eu = (hour >= 7) & (hour < 15)
    us = (hour >= 13) & (hour < 21)
    minute = torch.div(torch.remainder(sec_in_day, 3600), 60, rounding_mode="floor")
    top_hr = minute == 0
    trans = ((hour == 0) | (hour == 7) | (hour == 13)) & top_hr
    return (torch.sin(phase), torch.cos(phase), torch.sin(phase_w),
            torch.cos(phase_w), asia, eu, us, trans, top_hr)
