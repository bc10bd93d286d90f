"""The bars -> features chain on one device, with one readback at the end.

Counterpart of ``finmlkit_tpu/pipeline.py``. :func:`bar_feature_dispatch`
queues, on device tensors, the bar products (the bar scan of ``bar/fused.py``,
kernel B by default), the median trade sizes when the amounts are given, the
finals, the feature-ready bar columns and a planned feature graph
(``feature/fuse.FusedGraph.run_device``); then it queues every device-to-host
copy into pinned host memory and records one CUDA event. Nothing blocks.
:func:`bar_feature_drain` waits on that event and hands back numpy dicts. The
split lets a caller queue the next month before it drains this one.

The JAX pipeline's packed final-dtype buffer, its host assembly of the finals
and its ``feat_dtype`` (float32 feature inputs, a TPU fast path) do not cross:
the finals come from ``bar/fused.bar_finals`` on the device, and the features
work in float64. ``interpret`` is ``plain`` here (every kernel's plain
version) and ``scan_kernel`` is ``scan`` (the kits' names, "rowtail" or
"planes"). On CPU tensors every stage runs its plain version and the copies
are the tensors themselves.
"""
from typing import Dict, NamedTuple, Optional

import torch

from .bar.fused import bar_finals, bar_scan, median_engine

__all__ = ["bar_feature_pipeline_device", "bar_feature_dispatch",
           "bar_feature_drain", "bar_cols_from_final"]

_COLS = ("open", "high", "low", "close", "volume", "vwap", "trades")


class Handles(NamedTuple):
    """What :func:`bar_feature_dispatch` queued: host copies of the finals
    and the features, and the event that marks them whole (None on the
    CPU)."""
    ohlcv: Dict[str, torch.Tensor]
    directional: Dict[str, torch.Tensor]
    features: Dict[str, torch.Tensor]
    done: Optional[torch.cuda.Event]


def bar_cols_from_final(ohlcv: dict) -> Dict[str, torch.Tensor]:
    """The feature-ready bar columns of the finals ``ohlcv``: float64 open,
    high, low, close and vwap, the float32 volume widened to float64 (as the
    JAX host path's frame widens it, ``pipeline.py:66-67``) and int64 trade
    counts."""
    cols = {k: ohlcv[k] for k in _COLS}
    cols["volume"] = ohlcv["volume"].to(torch.float64)
    return cols


def _host_copies(cols: dict) -> dict:
    """Queue a copy of each CUDA tensor into pinned host memory."""
    out = {}
    for k, v in cols.items():
        if v.is_cuda:
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            v = h
        out[k] = v
    return out


def bar_feature_dispatch(ticks, units, ci, sides, *, tick_size, amount_scale, graph,
                         bar_ts=None, amounts_f32=None, plain: bool = False,
                         scan: str = "rowtail") -> Handles:
    """Queue the chain (bars -> medians -> features) and every readback;
    returns the :class:`Handles` for :func:`bar_feature_drain`.

    ``ticks`` int32, ``units`` int64 and ``sides`` int8 are per trade, ``ci``
    int64 the close indices (the open anchor first), all on one device.
    ``graph`` is a :class:`~finmlkit_tpu_torch.feature.fuse.FusedGraph` over
    the bar columns (open, high, low, close, volume, vwap, trades) and
    ``bar_ts`` the bars' int64 ns timestamps, if its features read them.
    ``amounts_f32`` (float32 per trade) gives the median trade sizes; without
    it ``median_trade_size`` is NaN: the JAX pipeline fills 0.0 there, which
    reads as data (ROADMAP.md, Queue 3, R4). The medians come from the sort
    engine, as the JAX pipeline's from its row sort. ``scan`` names the bar
    scan as the kits do; ``plain`` runs every stage's plain version. It
    takes quantized trades only, as the JAX pipeline does: ``ticks`` None
    (trades on no tick grid) raises."""
    if ticks is None or units is None:
        raise ValueError("bar_feature_dispatch takes integer ticks and units")
    p64, p32, pf = bar_scan(scan, plain=plain)(ticks, units, sides, ci)
    n_bars = ci.shape[0] - 1
    if amounts_f32 is not None:
        med = median_engine("sort", plain=plain)(amounts_f32, ci)
    else:
        nan = torch.full((n_bars,), float("nan"), dtype=torch.float32, device=ci.device)
        med = (nan, nan)
    ohlcv, direc = bar_finals(p64, p32, pf, med, ci, tick_size, amount_scale)
    if amounts_f32 is None:
        ohlcv["median_trade_size"] = med[0].to(torch.float64)
    feats = graph.run_device(bar_cols_from_final(ohlcv), ts=bar_ts)
    handles = Handles(_host_copies(ohlcv), _host_copies(direc), _host_copies(feats), None)
    if ci.is_cuda:
        handles = handles._replace(done=torch.cuda.Event())
        handles.done.record()
    return handles


def bar_feature_drain(handles: Handles):
    """Wait for :func:`bar_feature_dispatch`'s copies; returns ``(ohlcv,
    directional, features)`` as dicts of numpy arrays."""
    if handles.done is not None:
        handles.done.synchronize()

    def host(d):
        return {k: v.numpy() for k, v in d.items()}
    return host(handles.ohlcv), host(handles.directional), host(handles.features)


def bar_feature_pipeline_device(ticks, units, ci, sides, *, tick_size, amount_scale,
                                graph, bar_ts=None, amounts_f32=None, plain: bool = False,
                                scan: str = "rowtail"):
    """:func:`bar_feature_dispatch` then :func:`bar_feature_drain`: bars,
    medians and features with no host hop between the stages. Returns
    ``(ohlcv, directional, features)`` as dicts of numpy arrays."""
    return bar_feature_drain(bar_feature_dispatch(
        ticks, units, ci, sides, tick_size=tick_size, amount_scale=amount_scale,
        graph=graph, bar_ts=bar_ts, amounts_f32=amounts_f32, plain=plain, scan=scan))
