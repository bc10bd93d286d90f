"""Transform framework: feature transforms with declared inputs and outputs.

Counterpart of ``finmlkit_tpu/feature/base.py``: the same abstract contract
(``requires`` / ``produces``, the SISO / MISO / SIMO / MIMO transforms, the
operator transforms that short-circuit on cached columns) and the same output
names: SISO ``{input}_{produces}``, MISO and MIMO ``produces`` verbatim, SIMO
``{input}_{p_i}``, operator transforms ``add(x,y)`` and the like.

The frame is a dict of equal-length 1-D tensors on one device, with the bars'
int64 nanosecond close timestamps under ``"timestamp"`` (the JAX package's
DataFrame and its ``DatetimeIndex``): the bar kits' dicts feed it as they
are. A transform returns a tensor, or a tuple of tensors for the
multi-output transforms. There is one tier, the JAX package's ``_jax``
semantics, in PyTorch (``_compute``); its ``backend=`` switch and pandas
tiers do not cross.
"""
from abc import ABC, abstractmethod
from typing import Callable, Sequence, Union

import numpy as np
import torch

TIMESTAMP = "timestamp"


def as_frame(x, device="cuda") -> dict:
    """``x`` as a frame: a dict whose numpy (or list) values become tensors
    on ``device``; tensor values stay where they are."""
    if not isinstance(x, dict):
        raise TypeError("Input must be a dict of tensors")
    if all(torch.is_tensor(v) for v in x.values()):
        return x
    return {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v)).to(device)
            for k, v in x.items()}


class BaseTransform(ABC):
    """Abstract transform: declared input and output columns."""

    requires: list
    produces: list

    def __init__(self, input_cols: Union[Sequence, str], output_cols: Union[Sequence, str]):
        if not isinstance(input_cols, (str, tuple, list)):
            raise TypeError(f"Input columns must be a string or a sequence of strings. "
                            f"Got {type(input_cols)}")
        if not isinstance(output_cols, (str, tuple, list)):
            raise TypeError(f"Output columns must be a string or a sequence of strings. "
                            f"Got {type(output_cols)}")
        self.requires = [input_cols] if isinstance(input_cols, str) else list(input_cols)
        self.produces = [output_cols] if isinstance(output_cols, str) else list(output_cols)

    @abstractmethod
    def __call__(self, x: dict, *, device="cuda"):
        ...

    @abstractmethod
    def _validate_input(self, x: dict) -> bool:
        ...

    @property
    @abstractmethod
    def output_name(self):
        ...


class CoreTransform(BaseTransform, ABC):
    """A transform computed by ``_compute`` on a validated frame."""

    def __call__(self, x: dict, *, device="cuda"):
        x = as_frame(x, device)
        self._validate_input(x)
        return self._compute(x)

    @staticmethod
    def _get_timestamps(x: dict) -> torch.Tensor:
        if TIMESTAMP not in x:
            raise ValueError("Input frame must have a 'timestamp' column for time-based "
                             "features.")
        return x[TIMESTAMP]

    @abstractmethod
    def _compute(self, x: dict):
        ...


def _require_one(t, x) -> bool:
    if not isinstance(x, dict):
        raise TypeError("Input must be a dict of tensors")
    if t.requires[0] not in x:
        raise ValueError(f"Input column {t.requires[0]} not found in DataFrame")
    return True


def _require_all(t, x) -> bool:
    if not isinstance(x, dict):
        raise TypeError("Input must be a dict of tensors")
    missing = [c for c in t.requires if c not in x]
    if missing:
        raise ValueError(f"Input columns {missing} not found in DataFrame")
    return True


def _outputs(t, y) -> tuple:
    if len(y) != len(t.produces):
        raise ValueError(f"Expected {len(t.produces)} outputs, got {len(y)}")
    return tuple(y)


class SISOTransform(CoreTransform, ABC):
    """Single input -> single output; name = ``{input}_{produces}``."""

    def __init__(self, input_col: str, output_col: str):
        super().__init__(input_col, output_col)

    def _validate_input(self, x):
        return _require_one(self, x)

    def _prepare_input(self, x: dict) -> torch.Tensor:
        return x[self.requires[0]]

    @property
    def output_name(self) -> str:
        return f"{self.requires[0]}_{self.produces[0]}"


class MISOTransform(CoreTransform, ABC):
    """Multiple inputs -> single output; name = produces verbatim."""

    def __init__(self, input_cols: Sequence, output_col: str):
        super().__init__(input_cols, output_col)

    def _validate_input(self, x):
        return _require_all(self, x)

    def _prepare_input(self, x: dict) -> dict:
        return {c: x[c] for c in self.requires}

    @property
    def output_name(self) -> str:
        return self.produces[0]


class SIMOTransform(CoreTransform, ABC):
    """Single input -> multiple outputs; names = ``{input}_{p_i}``."""

    def __init__(self, input_col: str, output_cols: Sequence):
        super().__init__(input_col, output_cols)

    def _validate_input(self, x):
        return _require_one(self, x)

    def _prepare_input(self, x: dict) -> torch.Tensor:
        return x[self.requires[0]]

    @property
    def output_name(self) -> list:
        return [f"{self.requires[0]}_{c}" for c in self.produces]

    def _prepare_output(self, y) -> tuple:
        return _outputs(self, y)


class MIMOTransform(CoreTransform, ABC):
    """Multiple inputs -> multiple outputs; names = produces verbatim."""

    def __init__(self, input_cols: Sequence, output_cols: Sequence):
        super().__init__(input_cols, output_cols)

    def _validate_input(self, x):
        return _require_all(self, x)

    def _prepare_input(self, x: dict) -> dict:
        return {c: x[c] for c in self.requires}

    @property
    def output_name(self) -> list:
        return list(self.produces)

    def _prepare_output(self, y) -> tuple:
        return _outputs(self, y)


# ---------------------------------------------------------------------------
# Operator transforms (cache-aware composition)
# ---------------------------------------------------------------------------

class _OpTransformBase(BaseTransform, ABC):
    """Shared cache short-circuit of the operator transforms."""

    @property
    def output_name(self):
        if isinstance(self.produces, list) and len(self.produces) == 1:
            return self.produces[0]
        return self.produces

    def _cached(self, x):
        out_name = self.output_name if isinstance(self.output_name, str) else self.produces[0]
        return x.get(out_name)

    @staticmethod
    def _child_result(child, x, device):
        if isinstance(child.output_name, str) and child.output_name in x:
            return x[child.output_name]
        return child(x, device=device)


class _PairOpTransform(_OpTransformBase):
    """An elementwise op between two transforms' outputs."""

    _what = "binary OP"

    def __init__(self, left: BaseTransform, right: BaseTransform,
                 op_name: str, op_func: Callable):
        combined = list(set(left.requires + right.requires))
        super().__init__(combined, f"{op_name}({left.output_name},{right.output_name})")
        self.left, self.right = left, right
        self.op_func, self.op_name = op_func, op_name

    def _validate_input(self, x):
        for side, t in (("Left", self.left), ("Right", self.right)):
            if not isinstance(t, (SISOTransform, MISOTransform, _OpTransformBase)):
                raise TypeError(f"{side} transform must be SISO or MISO for "
                                f"{self._what}, got {type(t)}")
        return self.left._validate_input(x) and self.right._validate_input(x)

    def __call__(self, x, *, device="cuda"):
        x = as_frame(x, device)
        cached = self._cached(x)
        if cached is not None:
            return cached
        left = self._child_result(self.left, x, device)
        right = self._child_result(self.right, x, device)
        return self.op_func(left, right)


class BinaryOpTransform(_PairOpTransform):
    """Elementwise binary op between two transforms' outputs."""


class MinMaxOpTransform(_PairOpTransform):
    """Elementwise min/max between two transforms' outputs."""

    @property
    def _what(self):
        return f"{self.produces[0]} OP"


class ConstantOpTransform(_OpTransformBase):
    """Elementwise op between a transform's output and a constant."""

    def __init__(self, transform: BaseTransform, constant: float,
                 op_name: str, op_func: Callable):
        super().__init__(transform.requires,
                         f"{op_name}({transform.output_name},{constant})")
        self.transform = transform
        self.constant = constant
        self.op_func, self.op_name = op_func, op_name

    def _validate_input(self, x):
        return self.transform._validate_input(x)

    def __call__(self, x, *, device="cuda"):
        x = as_frame(x, device)
        cached = self._cached(x)
        if cached is not None:
            return cached
        return self.op_func(self._child_result(self.transform, x, device), self.constant)


class UnaryOpTransform(_OpTransformBase):
    """Elementwise unary op on a transform's output."""

    def __init__(self, transform: BaseTransform, op_name: str, op_func: Callable):
        super().__init__(transform.requires, f"{op_name}({transform.output_name})")
        self.transform = transform
        self.op_func, self.op_name = op_func, op_name

    def _validate_input(self, x):
        return self.transform._validate_input(x)

    def __call__(self, x, *, device="cuda"):
        x = as_frame(x, device)
        cached = self._cached(x)
        if cached is not None:
            return cached
        return self.op_func(self._child_result(self.transform, x, device))
