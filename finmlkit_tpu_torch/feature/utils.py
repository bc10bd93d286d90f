"""Feature serialization (JSON configs) and the computation graph.

Counterpart of ``finmlkit_tpu/feature/utils.py``: recursive configs by kind
(binary / minmax / const / unary / compose / external / a transform by its
constructor's parameters), the unary ops by recorded name (``clip_*``,
``rmean``/``rstd``/``rsum``/``tsum``/``ema``/``lag`` + N) as torch functions
with pandas' semantics, timedelta encoding, and the dependency graph of a
feature list with Kahn's topological sort.

A class path under ``finmlkit_tpu.`` in a config maps to the same path under
``finmlkit_tpu_torch.``, by string, so a config saved by the JAX package's
``FeatureKit`` builds the same kit here. Nothing of the JAX package is
imported.
"""
from __future__ import annotations

import datetime
import importlib
import inspect
from typing import Any, Dict, List, Set

import numpy as np
import torch

from ..utils.log import get_logger
from ..ops.scan import linear_recurrence
from .base import (BaseTransform, BinaryOpTransform, ConstantOpTransform,
                   MinMaxOpTransform, UnaryOpTransform)
from .kernels._rolling import roll_sum, sliding_windows, warmup_nan

logger = get_logger(__name__)

_JAX_PREFIX, _PORT_PREFIX = "finmlkit_tpu.", "finmlkit_tpu_torch."


# --- value (de)serialization -------------------------------------------------

def _serialize_value(val: Any) -> Any:
    if isinstance(val, datetime.timedelta):
        return {"__timedelta__": True, "seconds": val.total_seconds()}
    if isinstance(val, (str, int, float, bool)) or val is None:
        return val
    if isinstance(val, (list, tuple)):
        return [_serialize_value(v) for v in val]
    if isinstance(val, dict):
        return {k: _serialize_value(v) for k, v in val.items()}
    if isinstance(val, np.generic):
        return val.item()
    return str(val)


def _deserialize_value(val: Any) -> Any:
    if isinstance(val, dict) and val.get("__timedelta__"):
        return datetime.timedelta(seconds=val["seconds"])
    if isinstance(val, list):
        return [_deserialize_value(v) for v in val]
    if isinstance(val, dict):
        return {k: _deserialize_value(v) for k, v in val.items()}
    return val


def _class_path(obj: Any) -> str:
    cls = obj if isinstance(obj, type) else obj.__class__
    return f"{cls.__module__}.{cls.__name__}"


def _import_class(path: str):
    if path.startswith(_JAX_PREFIX):
        path = _PORT_PREFIX + path[len(_JAX_PREFIX):]
    module_name, cls_name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module_name), cls_name)


# --- elementwise and rolling ops with pandas' semantics -----------------------

def _like(c, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(c, dtype=x.dtype if x.is_floating_point() else torch.float64,
                           device=x.device)


def minimum(x, y):
    """``np.minimum``: elementwise, a NaN on either side gives NaN."""
    return torch.minimum(x, _like(y, x))


def maximum(x, y):
    """``np.maximum``: elementwise, a NaN on either side gives NaN."""
    return torch.maximum(x, _like(y, x))


def _float(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.float64)


def log(x):
    """``log(v)`` where ``v > 0``, else NaN."""
    x = _float(x)
    return torch.where(x > 0, torch.log(x), torch.nan)


def log1p(x):
    """``log1p(v)`` where ``v >= 0``, else NaN."""
    x = _float(x)
    return torch.where(x >= 0, torch.log1p(x), torch.nan)


def exp(x):
    return torch.exp(_float(x))


def square(x):
    return x ** 2


def sqrt(x):
    """``sqrt(v)`` where ``v >= 0``, else NaN."""
    x = _float(x)
    return torch.where(x >= 0, torch.sqrt(x), torch.nan)


def clip(lower=None, upper=None):
    """``Series.clip``: a NaN stays NaN."""
    return lambda x: torch.clamp(x, min=lower, max=upper)


def rolling_mean(window: int):
    """``rolling(window).mean()``: NaN until a full window, and for a window
    that holds a NaN."""
    return lambda x: warmup_nan(roll_sum(_float(x), window) / window, window)


def rolling_sum(window: int):
    """``rolling(window).sum()``, NaN as :func:`rolling_mean`."""
    return lambda x: warmup_nan(roll_sum(_float(x), window), window)


def rolling_std(window: int):
    """``rolling(window).std()`` (ddof 1), NaN as :func:`rolling_mean`; each
    window's deviations from its own mean, so a price level does not
    cancel."""
    def f(x):
        x = _float(x)
        w = sliding_windows(x, window)
        mean = w.sum(1, keepdim=True) / window
        var = ((w - mean) ** 2).sum(1) / (window - 1)
        return warmup_nan(torch.sqrt(var), window)
    return f


def ema(span: int, adjust: bool = True):
    """``ewm(span=span, adjust=adjust).mean()``: a NaN is skipped (the weights
    still decay across it, pandas' ``ignore_na=False``), NaN before the first
    value. With ``adjust`` the mean is the ratio of two geometric sums over
    the valid values, each by kernel R; without, the recurrence
    ``y = (w y + a x) / (w + a)``, ``w`` the weight ``(1 - a)^k`` decayed over
    the k steps since the last value."""
    alpha = 2.0 / (span + 1.0)

    def f(x):
        x = _float(x)
        valid = ~torch.isnan(x)
        if adjust:
            num = linear_recurrence(1.0 - alpha, torch.where(valid, x, 0.0))
            den = linear_recurrence(1.0 - alpha, valid.to(torch.float64))
            return torch.where(den > 0, num / den, torch.nan)
        seen = torch.cumsum(valid.to(torch.int64), 0)
        idx = torch.arange(x.shape[0], device=x.device)
        last = torch.cummax(torch.where(valid, idx, -1), 0).values
        prev = torch.cat([last.new_full((1,), -1), last[:-1]])
        w = (1.0 - alpha) ** (idx - prev).to(torch.float64)
        a = torch.where(valid & (seen > 1), w / (w + alpha), 1.0)
        b = torch.where(valid, torch.where(seen > 1, alpha / (w + alpha), 1.0) * x, 0.0)
        a = torch.where(valid & (seen == 1), 0.0, a)
        y = linear_recurrence(a, b)
        return torch.where(seen > 0, y, torch.nan)
    return f


def lag(periods: int):
    """``shift(periods)``: NaN where no earlier (or later) value is."""
    def f(x):
        x = _float(x)
        out = torch.full_like(x, torch.nan)
        n = x.shape[0]
        if periods >= 0:
            out[periods:] = x[:max(n - periods, 0)]
        else:
            out[:n + periods] = x[-periods:]
        return out
    return f


# --- op registries -----------------------------------------------------------

OP_BINARY = {
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y,
    "rsub": lambda x, y: y - x,
    "rdiv": lambda x, y: y / x,
}

OP_MINMAX = {"min": minimum, "max": maximum}

OP_UNARY = {
    "abs": torch.abs,
    "log": log,
    "log1p": log1p,
    "exp": exp,
    "square": square,
    "sqrt": sqrt,
}


def resolve_unary_op(name: str):
    """The unary op recorded as ``name``, the parameterized families
    ``clip_<lo>_<hi>`` and ``rmean``/``rstd``/``rsum``/``tsum``/``ema``/
    ``lag`` + N included; None for an unknown name."""
    if name.startswith("clip_"):
        parts = name.split("_")

        def _bound(i):
            try:
                return float(parts[i]) if len(parts) > i and parts[i] != "" else None
            except (ValueError, IndexError):
                return None
        return clip(_bound(1), _bound(2))

    for prefix, maker in (("rmean", rolling_mean), ("rstd", rolling_std),
                          ("rsum", rolling_sum), ("tsum", rolling_sum),
                          ("ema", ema), ("lag", lag)):
        if name.startswith(prefix):
            try:
                return maker(int(name[len(prefix):]))
            except ValueError:
                break
    return OP_UNARY.get(name)


# --- transform (de)serialization --------------------------------------------

def transform_to_config(t: BaseTransform) -> Dict[str, Any]:
    """Recursively serialize a transform tree to a JSON-able dict."""
    cfg: Dict[str, Any] = {
        "class": _class_path(t),
        "requires": list(getattr(t, "requires", [])),
        "produces": list(getattr(t, "produces", [])),
    }

    def _op_name(default):
        name = getattr(t, "op_name", None)
        if name:
            return name
        produced = t.produces[0] if isinstance(t.produces, list) else t.produces
        return produced.split("(")[0] or default

    if isinstance(t, (BinaryOpTransform, MinMaxOpTransform)):
        cfg["kind"] = "binary" if isinstance(t, BinaryOpTransform) else "minmax"
        cfg["op_name"] = _op_name("add")
        cfg["left"] = transform_to_config(t.left)
        cfg["right"] = transform_to_config(t.right)
        return cfg
    if isinstance(t, ConstantOpTransform):
        cfg["kind"] = "const"
        cfg["op_name"] = _op_name("add")
        cfg["constant"] = t.constant
        cfg["child"] = transform_to_config(t.transform)
        return cfg
    if isinstance(t, UnaryOpTransform):
        cfg["kind"] = "unary"
        cfg["op_name"] = _op_name("abs")
        cfg["child"] = transform_to_config(t.transform)
        return cfg
    if getattr(t, "_is_external_function", False):
        cfg["kind"] = "external"
        cfg["func"] = getattr(t, "func_path", None)
        cfg["args"] = _serialize_value(getattr(t, "args", []))
        cfg["kwargs"] = _serialize_value(getattr(t, "kwargs", {}))
        cfg["pass_numpy"] = bool(getattr(t, "pass_numpy", False))
        return cfg
    if isinstance(getattr(t, "transforms", None), (list, tuple)):
        cfg["kind"] = "compose"
        cfg["steps"] = [transform_to_config(s) for s in t.transforms]
        return cfg

    # a transform: the constructor's parameters found on the instance
    cfg["kind"] = "transform"
    params: Dict[str, Any] = {}
    for name in inspect.signature(t.__class__.__init__).parameters:
        if name == "self":
            continue
        if name == "input_col":
            params[name] = t.requires[0]
        elif name == "input_cols":
            params[name] = list(t.requires)
        elif hasattr(t, name):
            params[name] = getattr(t, name)
    cfg["params"] = {k: _serialize_value(v) for k, v in params.items()}
    return cfg


def transform_from_config(cfg: Dict[str, Any]) -> BaseTransform:
    """Rebuild a transform tree from its config dict."""
    kind = cfg.get("kind")
    if kind in ("binary", "minmax"):
        left = transform_from_config(cfg["left"])
        right = transform_from_config(cfg["right"])
        op_name = cfg.get("op_name", "add" if kind == "binary" else "min")
        op = (OP_BINARY if kind == "binary" else OP_MINMAX).get(op_name)
        if op is None:
            raise ValueError(f"Unsupported {kind} op: {op_name}")
        cls = BinaryOpTransform if kind == "binary" else MinMaxOpTransform
        return cls(left, right, op_name, op)
    if kind == "const":
        child = transform_from_config(cfg["child"])
        op_name = cfg.get("op_name", "add")
        const = cfg.get("constant")
        if op_name in OP_BINARY:
            if op_name in ("add", "sub", "mul", "div"):
                fn = OP_BINARY[op_name]
            else:
                fn = (lambda x, c: c - x) if op_name == "rsub" else (lambda x, c: c / x)
            return ConstantOpTransform(child, const, op_name, fn)
        if op_name in OP_MINMAX:
            return ConstantOpTransform(child, const, op_name, OP_MINMAX[op_name])
        raise ValueError(f"Unsupported const op: {op_name}")
    if kind == "unary":
        child = transform_from_config(cfg["child"])
        op_name = cfg.get("op_name", "abs")
        op = resolve_unary_op(op_name)
        if op is None:
            raise ValueError(f"Unsupported unary op: {op_name}")
        return UnaryOpTransform(child, op_name, op)
    if kind == "compose":
        from .kit import Compose
        return Compose(*[transform_from_config(s) for s in cfg.get("steps", [])])
    if kind == "external":
        from .transforms import ExternalFunction
        func_path = cfg.get("func")
        if not func_path:
            raise ValueError("ExternalFunction config requires 'func' path")
        reqs = cfg.get("requires", [])
        if not reqs:
            raise ValueError("ExternalFunction config missing 'requires'")
        input_cols = reqs[0] if len(reqs) == 1 else reqs
        produces = cfg.get("produces", [])
        output_cols = (produces[0] if len(produces) == 1 else produces) \
            if isinstance(produces, list) else produces
        return ExternalFunction(
            func_path, input_cols, output_cols,
            args=_deserialize_value(cfg.get("args", [])),
            kwargs=_deserialize_value(cfg.get("kwargs", {})),
            pass_numpy=bool(cfg.get("pass_numpy", False)))

    cls = _import_class(cfg["class"])
    params = {k: _deserialize_value(v) for k, v in cfg.get("params", {}).items()}
    try:
        return cls(**params)
    except TypeError as e:
        # the JAX package's configs record only the parameters that its
        # transforms keep under their own names; the rest is set as found
        logger.warning(f"Falling back to shallow reconstruction for {cfg['class']}: {e}")
        obj = cls.__new__(cls)
        obj.requires = cfg.get("requires", [])
        obj.produces = cfg.get("produces", [])
        for k, v in params.items():
            setattr(obj, k, v)
        return obj


# --- computation graph -------------------------------------------------------

class ComputationGraph:
    """DAG of feature dependencies with Kahn's topological sort."""

    def __init__(self):
        self.edges: Dict[str, Set[str]] = {}
        self.nodes: Set[str] = set()

    def add_node(self, node: str):
        self.nodes.add(node)
        self.edges.setdefault(node, set())

    def add_edge(self, src: str, dst: str):
        self.add_node(src)
        self.add_node(dst)
        self.edges[src].add(dst)

    def topological_sort(self) -> List[str]:
        indeg = {n: 0 for n in self.nodes}
        for dests in self.edges.values():
            for d in dests:
                indeg[d] += 1
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for d in sorted(self.edges.get(n, ())):
                indeg[d] -= 1
                if indeg[d] == 0:
                    ready.append(d)
        return order

    def visualize(self) -> str:
        lines = ["ComputationGraph:"]
        for src in sorted(self.edges):
            lines.append(f"  {src} -> [{', '.join(sorted(self.edges[src]))}]")
        return "\n".join(lines)


def _flatten_requires(t: BaseTransform) -> List[str]:
    if isinstance(t, (BinaryOpTransform, MinMaxOpTransform)):
        return list(set(_flatten_requires(t.left) + _flatten_requires(t.right)))
    if isinstance(t, (UnaryOpTransform, ConstantOpTransform)):
        return _flatten_requires(t.transform)
    if isinstance(getattr(t, "transforms", None), (list, tuple)):
        return list(t.transforms[0].requires)
    return list(getattr(t, "requires", []))


def _child_output_names(t: BaseTransform) -> List[str]:
    if isinstance(t, (BinaryOpTransform, MinMaxOpTransform)):
        return [str(t.left.output_name), str(t.right.output_name)]
    if isinstance(t, (UnaryOpTransform, ConstantOpTransform)):
        return [str(t.transform.output_name)]
    if isinstance(getattr(t, "transforms", None), (list, tuple)):
        return [str(t.transforms[0].output_name)]
    return []


def build_feature_graph(features) -> ComputationGraph:
    """The dependency DAG: ``input:<col>`` -> feature edges, and edges between
    features where one's output feeds another."""
    g = ComputationGraph()
    outputs = {str(f.name) for f in features if isinstance(f.name, str)}
    for f in features:
        out = str(f.name)
        g.add_node(out)
        reqs = _flatten_requires(f.transform)
        for r in reqs:
            g.add_edge(f"input:{r}", out)
        for child in _child_output_names(f.transform):
            if child in outputs and child != out:
                g.add_edge(child, out)
        for other in outputs:
            if other != out and other in reqs:
                g.add_edge(other, out)
    return g
