"""Feature / Compose / FeatureKit: the fluent pipeline API.

Counterpart of ``finmlkit_tpu/feature/kit.py``: a ``Feature`` wraps a
transform with math operators and the column cache; ``Compose`` chains
single-output transforms; ``FeatureKit`` runs a feature list over a frame (a
dict of tensors with ``"timestamp"``, as the bar kits return), in defined or
topological order, each feature reading earlier outputs from the cache.
Nothing falls back: a failure raises.
"""
import contextlib
import json
import os
import time

import torch

from ..utils import trace
from . import utils as U
from .base import (BaseTransform, BinaryOpTransform, ConstantOpTransform,
                   MinMaxOpTransform, TIMESTAMP, UnaryOpTransform, as_frame)
from .utils import (ComputationGraph, build_feature_graph, transform_from_config,
                    transform_to_config)


class Feature:
    """Fluent wrapper around a transform with math operators and caching."""

    def __init__(self, transform: BaseTransform):
        self.transform = transform
        self._name = transform.output_name

    def __call__(self, x: dict, *, cache: dict = None, device="cuda"):
        if cache is not None and isinstance(self.transform.output_name, str) \
                and self.transform.output_name in cache:
            return cache[self.transform.output_name]
        return self.transform(x, device=device)

    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, output_name):
        if type(output_name) is not type(self._name):
            raise TypeError("a feature's new name must have its old name's type")
        if isinstance(output_name, (tuple, list)) and len(output_name) != len(self._name):
            raise ValueError("a feature's new names must be as many as its old")
        self._name = output_name

    # --- serialization ------------------------------------------------
    def to_config(self) -> dict:
        return {
            "name": self._name if isinstance(self._name, str) else list(self._name),
            "transform": transform_to_config(self.transform),
        }

    @staticmethod
    def from_config(cfg: dict) -> "Feature":
        f = Feature(transform_from_config(cfg["transform"]))
        name = cfg.get("name")
        if name is not None:
            f.name = name if isinstance(f._name, str) or not isinstance(name, list) else list(name)
        return f

    # --- functional composition ---------------------------------------
    def apply(self, func, *args, suffix=None, **kwargs):
        """Apply a callable (tensor in, tensor out) to this feature's output."""
        func_name = suffix if suffix is not None else func.__name__
        new_name = f"{self.name}_{func_name}"
        transform = UnaryOpTransform(self.transform, func_name,
                                     lambda x: func(x, *args, **kwargs))
        transform.produces = [new_name]
        feature = Feature(transform)
        feature.name = new_name
        return feature

    # --- arithmetic operators ------------------------------------------
    def _binary(self, other, op_name):
        op = U.OP_BINARY[op_name]
        if isinstance(other, Feature):
            return Feature(BinaryOpTransform(self.transform, other.transform, op_name, op))
        if isinstance(other, (int, float)):
            return Feature(ConstantOpTransform(self.transform, other, op_name, op))
        return NotImplemented

    def __add__(self, other):
        return self._binary(other, "add")

    def __sub__(self, other):
        return self._binary(other, "sub")

    def __mul__(self, other):
        return self._binary(other, "mul")

    def __truediv__(self, other):
        return self._binary(other, "div")

    def _reflected(self, other, op_name, op):
        if isinstance(other, (int, float)):
            return Feature(ConstantOpTransform(self.transform, other, op_name, op))
        return NotImplemented

    def __radd__(self, other):
        return self._reflected(other, "add", lambda x, c: x + c)

    def __rmul__(self, other):
        return self._reflected(other, "mul", lambda x, c: x * c)

    def __rsub__(self, other):
        return self._reflected(other, "rsub", lambda x, c: c - x)

    def __rtruediv__(self, other):
        return self._reflected(other, "rdiv", lambda x, c: c / x)

    def __abs__(self):
        return Feature(UnaryOpTransform(self.transform, "abs", torch.abs))

    # --- convenience ops -----------------------------------------------
    def abs(self):
        return self.__abs__()

    def clip(self, lower=None, upper=None):
        suffix = f"clip_{lower}_{upper}".replace("None", "")
        return self.apply(U.clip(lower, upper), suffix=suffix)

    def log(self):
        return self.apply(U.log, suffix="log")

    def log1p(self):
        return self.apply(U.log1p, suffix="log1p")

    def exp(self):
        return self.apply(U.exp, suffix="exp")

    def square(self):
        return self.apply(U.square, suffix="square")

    def sqrt(self):
        return self.apply(U.sqrt, suffix="sqrt")

    def rolling_mean(self, window):
        return self.apply(U.rolling_mean(window), suffix=f"rmean{window}")

    def ema(self, span, adjust=True):
        return self.apply(U.ema(span, adjust), suffix=f"ema{span}")

    def rolling_sum(self, window):
        return self.apply(U.rolling_sum(window), suffix=f"rsum{window}")

    def rolling_std(self, window):
        return self.apply(U.rolling_std(window), suffix=f"rstd{window}")

    def lag(self, period):
        return self.apply(U.lag(period), suffix=f"lag{period}")

    @staticmethod
    def min(a, b):
        return Feature._minmax(a, b, "min")

    @staticmethod
    def max(a, b):
        return Feature._minmax(a, b, "max")

    @staticmethod
    def _minmax(a, b, op_name):
        op = U.OP_MINMAX[op_name]
        if isinstance(a, Feature) and isinstance(b, Feature):
            return Feature(MinMaxOpTransform(a.transform, b.transform, op_name, op))
        if isinstance(a, Feature) and isinstance(b, (int, float)):
            return Feature(ConstantOpTransform(a.transform, b, op_name, op))
        if isinstance(b, Feature) and isinstance(a, (int, float)):
            return Feature(ConstantOpTransform(b.transform, a, op_name, op))
        return NotImplemented


class Compose(BaseTransform):
    """Sequential chain of single-output transforms with cache reuse. The
    name is the first output joined by ``_`` to each later step's
    ``produces``; a step whose output is in the frame is taken from it."""

    def __init__(self, *transforms):
        requires = transforms[0].requires[0]
        first_output = transforms[0].output_name
        produces = "_".join([first_output] + [t.produces[0] for t in transforms[1:]])
        super().__init__(requires, produces)
        self.transforms = transforms

    def _validate_input(self, x: dict) -> bool:
        if not isinstance(x, dict):
            raise TypeError("Input must be a dict of tensors")
        if self.requires[0] not in x:
            raise ValueError(f"Input column {self.requires} not found in DataFrame")
        return True

    @property
    def output_name(self) -> str:
        return self.produces[0]

    def __call__(self, x: dict, *, device="cuda"):
        x = as_frame(x, device)
        self._validate_input(x)
        if self.output_name in x:
            return x[self.output_name]
        current = None
        for i, t in enumerate(self.transforms):
            if t.produces[0] in x:
                current = x[t.produces[0]]
                continue
            if i == 0:
                current = t(x, device=device)
            else:
                req = t.requires[0]
                step = {req: x[req] if req in x else current}
                if TIMESTAMP in x:
                    step[TIMESTAMP] = x[TIMESTAMP]
                current = t(step, device=device)
        return current


def _names(t) -> list:
    n = t.output_name
    return [n] if isinstance(n, str) else list(n)


def _sync(frame: dict) -> None:
    for v in frame.values():
        if v.device.type == "cuda":
            torch.cuda.synchronize(v.device)
            return


class FeatureKit:
    """Batch executor over a list of Features with the column cache."""

    def __init__(self, features, retain=None):
        self.features = features
        self.retain = retain or []

    # --- serialization ------------------------------------------------
    def to_config(self) -> dict:
        return {
            "retain": list(self.retain),
            "features": [f.to_config() for f in self.features],
        }

    def save_config(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_config(), f, ensure_ascii=False, indent=2)

    @staticmethod
    def from_dict(cfg: dict) -> "FeatureKit":
        feats = [Feature.from_config(fc) for fc in cfg.get("features", [])]
        return FeatureKit(feats, retain=cfg.get("retain", []))

    @classmethod
    def from_config(cls, path: str) -> "FeatureKit":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    # --- graph --------------------------------------------------------
    def build_graph(self) -> ComputationGraph:
        return build_feature_graph(self.features)

    def topological_order(self):
        g = self.build_graph()
        names = [str(f.name) for f in self.features]
        name_set = set(names)
        edges = {n: set() for n in name_set}
        indeg = {n: 0 for n in name_set}
        for src, dests in g.edges.items():
            if src not in name_set:
                continue
            for d in dests:
                if d in name_set and d not in edges[src]:
                    edges[src].add(d)
                    indeg[d] += 1
        ready = [n for n in names if indeg[n] == 0]
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for d in sorted(edges[n]):
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(d)
        missing = [n for n in names if n not in order]
        return order + missing

    # --- execution ----------------------------------------------------
    def build(self, frame: dict, *, timeit=False, order: str = "defined",
              profile_dir: str = None, fuse: bool = None, device="cuda") -> dict:
        """Run every feature; returns a dict of the ``retain`` columns, then
        ``"timestamp"``, then each output by name.

        ``order="topo"`` runs the features in dependency order, so that those
        that read other features' outputs find them in the cache. ``fuse`` is
        accepted for the JAX signature and changes nothing: the JAX package's
        single compiled program does not cross, and the planned graph
        (``feature/fuse.py``) would run the same transforms in the same
        order. ``timeit`` prints each feature's wall time, the card
        synchronised before each clock read. Each feature runs in the trace
        registry's span ``feature.<name>`` (``utils/trace.py``).
        ``profile_dir`` (or ``FMKT_PROFILE_DIR``) records a ``torch.profiler``
        trace of the build, tracing on, so that each feature is an
        ``fmkt.feature.<name>`` range, written there as
        ``feature_trace.json``. Numpy columns go to ``device``.
        """
        profile_dir = profile_dir or os.environ.get("FMKT_PROFILE_DIR")
        frame = as_frame(frame, device)
        out = {c: frame[c] for c in self.retain}
        if TIMESTAMP in frame:
            out.setdefault(TIMESTAMP, frame[TIMESTAMP])
        cache = dict(frame)

        features_seq = self.features
        if order == "topo":
            name2feat = {str(f.name): f for f in self.features}
            topo = self.topological_order()
            features_seq = [name2feat[n] for n in topo if n in name2feat]
            features_seq += [f for f in self.features if str(f.name) not in set(topo)]

        was_on = trace.enabled()
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if torch.cuda.is_available() else [])
            trace_ctx = profile(activities=acts)
            trace.enable()       # the features' spans as fmkt.feature.<name> ranges
        else:
            trace_ctx = contextlib.nullcontext()

        timing = {}
        try:
            with trace_ctx as prof:
                for feat in features_seq:
                    if timeit:
                        _sync(cache)
                        t0 = time.perf_counter()
                    with trace.span(f"feature.{feat.name}"):
                        res = feat(cache, cache=cache, device=device)
                    if timeit:
                        _sync(cache)
                        timing[str(feat.name)] = time.perf_counter() - t0
                    self._store_result(out, cache, feat, res)
        finally:
            if not was_on:
                trace.disable()
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, "feature_trace.json"))

        if timeit:
            print("\nFeature Timing Analysis:")
            print("=======================")
            ordered = sorted(timing.items(), key=lambda kv: kv[1], reverse=True)
            max_t = max((t for _, t in ordered), default=0.0)
            for name, t in ordered:
                bar = "█" * (int(t / max_t * 50) if max_t > 0 else 0)
                print(f"{name:<30} | {bar} {t:.4f}s")
        return out

    @staticmethod
    def _store_result(out, cache, feat, res):
        if torch.is_tensor(res):
            out[feat.name] = res
            cache[feat.transform.output_name] = res
        elif isinstance(res, tuple):
            for name, item in zip(_names(feat.transform), res):
                out[name] = item
                cache[name] = item
        else:
            raise TypeError(f"Transform {feat} returned unexpected type: {type(res)}")
