"""The planned feature graph: graph features on the device first, host
features after.

Counterpart of ``finmlkit_tpu/feature/fuse.py``. ``plan`` splits a
topo-ordered feature list into graph features, which run on device tensors
from the frame's columns and earlier graph outputs, and host features: an
``ExternalFunction`` with ``pass_numpy=True`` (it takes numpy arrays), and a
feature that reads a host feature's output or writes a column an earlier
graph feature wrote. ``FusedGraph.run_device`` runs the graph and keeps its
outputs on the device, the entry for pipelines whose columns are already
device tensors; ``run`` copies them to host numpy once, at the end. Every
feature runs the same torch code as in ``FeatureKit.build``, so both give the
same bits, and ``build`` does not go through this module: its ``fuse=``
changes nothing.

The JAX package's single compiled program, its packed float64 input matrix
and per-dtype output buffers, its ``jax.eval_shape`` probe and its
``_TraceFrame`` are workarounds for the TPU's dispatch and transfer costs and
do not cross.
"""
from typing import Dict, List

import numpy as np
import torch

from .base import TIMESTAMP, as_frame
from .transforms import ExternalFunction


def _out_cols(t) -> List[str]:
    n = t.output_name
    return [n] if isinstance(n, str) else list(n)


def _host_only(t) -> bool:
    return isinstance(t, ExternalFunction) and t.pass_numpy


def plan(features, col_specs, ts_spec=None):
    """Split ``features`` into ``(graph, host)``: a feature joins the graph
    when it is not host-only, every column it requires is an input column
    (the keys of ``col_specs``, and the timestamps when ``ts_spec`` is given)
    or an earlier graph feature's output, and no earlier graph feature wrote
    its output columns (each feature keeps its own result, as on the
    per-feature path)."""
    env = set(col_specs) | ({TIMESTAMP} if ts_spec is not None else set())
    produced: set = set()
    graph, host = [], []
    for feat in features:
        t = feat.transform
        outs = _out_cols(t)
        if not _host_only(t) and all(r in env for r in t.requires) \
                and not produced.intersection(outs):
            env.update(outs)
            produced.update(outs)
            graph.append(feat)
        else:
            host.append(feat)
    return graph, host


class FusedGraph:
    """A planned feature graph bound to one FeatureKit feature sequence."""

    def __init__(self, graph_feats, host_feats):
        self.graph_feats = graph_feats
        self.host_feats = host_feats

    def run_device(self, cols: Dict[str, torch.Tensor], ts=None) -> Dict[str, torch.Tensor]:
        """Run the graph on device tensors ``cols`` (and the int64 ns
        timestamps ``ts``); returns its outputs by column, on the device."""
        env = dict(cols)
        if ts is not None:
            env[TIMESTAMP] = ts
        outs = {}
        for feat in self.graph_feats:
            y = feat.transform(env)
            for c, v in zip(_out_cols(feat.transform), y if isinstance(y, tuple) else (y,)):
                env[c] = v
                outs[c] = v
        return outs

    def run(self, cols: Dict[str, torch.Tensor], ts=None, *, device="cuda") \
            -> Dict[str, np.ndarray]:
        """:meth:`run_device` from a frame's columns (numpy columns go to
        ``device``), its outputs copied to host numpy once, at the end."""
        cols = as_frame(cols, device)
        if ts is not None and not torch.is_tensor(ts):
            ts = torch.from_numpy(np.asarray(ts, np.int64)).to(device)
        outs = self.run_device(cols, ts)
        return {c: v.cpu().numpy() for c, v in outs.items()}


def build_fused_from_specs(features, col_specs, ts_spec=None):
    """A FusedGraph from the names of the input columns (the keys of
    ``col_specs``), for pipelines whose columns are already device tensors.
    Every feature must plan onto the graph; a host feature raises."""
    graph, host = plan(features, col_specs, ts_spec)
    if host:
        raise ValueError(f"features {[f.name for f in host]} need host tiers; the "
                         "device-resident pipeline supports graph features only")
    return FusedGraph(graph, [])


def build_fused(features, frame: dict):
    """Plan a FusedGraph for ``features`` over ``frame``'s columns. Returns
    ``(FusedGraph, timestamps or None)``."""
    ts = frame.get(TIMESTAMP)
    cols = {c: v for c, v in frame.items() if c != TIMESTAMP}
    graph, host = plan(features, cols, ts)
    return FusedGraph(graph, host), ts
