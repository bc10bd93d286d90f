"""The comparison that decides ``correct``: the program's outputs of the
judged pass against the plain reference's, name by name.

The numbers, each held to the cell's limit (``limits/<cell>.json``):

- ``mismatches``: elements that differ in the integer and boolean outputs
  (close indices, counts, ticks, events, labels, touches, flags), plus the
  float elements that are finite on one side only or non-finite and
  different, plus every element of an output whose shape differs or that is
  missing;
- ``<group>_f64`` and ``<group>_f32``, one for each group of float outputs
  of that dtype (the group is the part of an output's name before its
  first dot: ``ohlcv``, ``directional``, ``labels``, ``weights``,
  ``footprints``, ``trade_size``): the widest gap between the two sides
  where both are finite, each output's gap over its scale (the largest
  magnitude of the reference's output, or the scale the reference states).

A number per group and dtype keeps each stage's precision apart: a float32
shortcut in one stage shows in its own number, not under another stage's
rounding. Which class an output falls in follows the reference's dtype.
"""
import math

import torch

MISMATCHES = "mismatches"


def number_of(name: str, dtype) -> str:
    return f"{name.split('.')[0]}_{'f32' if dtype == torch.float32 else 'f64'}"


def compare(got: dict, want: dict, scales: dict | None = None) -> dict:
    """The numbers of ``got`` (the program's outputs) against ``want`` (the
    reference's), both dicts of tensors by output name; ``scales``
    overrides the reference's largest magnitude of an output."""
    scales = scales or {}
    out = {MISMATCHES: 0}
    for name, w in want.items():
        key = number_of(name, w.dtype) if w.is_floating_point() else None
        if key is not None:
            out.setdefault(key, 0.0)
        g = got.get(name)
        if g is None or tuple(g.shape) != tuple(w.shape):
            out[MISMATCHES] += int(w.numel())
            continue
        g = g.to(w.device)
        if key is None:
            out[MISMATCHES] += int((g.to(torch.int64) != w.to(torch.int64)).sum())
            continue
        g, w = g.to(torch.float64), w.to(torch.float64)
        fin_g, fin_w = torch.isfinite(g), torch.isfinite(w)
        both = fin_g & fin_w
        odd = (fin_g != fin_w) | (~fin_g & ~fin_w & (g != w) & ~(g.isnan() & w.isnan()))
        out[MISMATCHES] += int(odd.sum())
        if not bool(both.any()):
            continue
        scale = scales.get(name)
        if scale is None:
            scale = float(w[both].abs().max())
        gap = float((g[both] - w[both]).abs().max())
        if gap > 0:
            out[key] = max(out[key], gap / scale if scale > 0 else math.inf)
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit; a number with no limit, or NaN,
    fails."""
    return all(k in limits and v <= limits[k] for k, v in numbers.items())
