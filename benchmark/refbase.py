"""What the plain reference's steps share: its run state, its precision and
a few segment helpers.

The reference is plain PyTorch. It imports nothing of the program (neither
``finmlkit_tpu_torch`` nor the JAX package) and takes nothing the program
made: it starts from the month's raw columns, quantizes them itself on the
configuration's grid, and computes each step's outputs from its own outputs
of the steps before. The program's outputs are read only by ``judge.py``.

``Precision`` is the arithmetic the reference computes in: float64 with the
float32 columns rounded once (the configuration's precision), or, for the
control, one step below it: float32 where the configuration states float64,
and bfloat16 where it states float32. Exact quantities (indices, counts,
integer sums) stay exact in both.
"""
import torch


class Precision:
    def __init__(self, control: bool = False):
        self.control = control
        self.f = torch.float32 if control else torch.float64

    def out32(self, x: torch.Tensor) -> torch.Tensor:
        """A float32 column, rounded from ``x`` (through bfloat16 in the control)."""
        if self.control:
            return x.to(torch.bfloat16).to(torch.float32)
        return x.to(torch.float32)

    def out64(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.float64)


class RefRun:
    """The reference's state over one pass: the month on ``device``, its
    own quantization, the thresholds, and the outputs by name (``out``, the
    names ``judge.py`` compares) and by step (``aux``)."""

    def __init__(self, month, grid: dict, thresholds: dict, device, prec: Precision):
        self.device, self.prec = device, prec
        self.tick, self.unit = float(grid["price_tick"]), float(grid["amount_unit"])
        self.thr = dict(thresholds)
        self.ts = torch.from_numpy(month.ts).to(device)
        self.price = torch.from_numpy(month.price).to(device)
        self.amount = torch.from_numpy(month.amount).to(device)
        self.side = torch.from_numpy(month.side).to(device)
        # the grid defines exact integers: quantized in float64 in the control too
        f64 = torch.float64
        self.ticks = torch.round(self.price / self.tick).to(torch.int64)
        self.units = torch.round(self.amount.to(f64) / self.unit).to(torch.int64)
        self.out, self.aux = {}, {}

    @property
    def n(self) -> int:
        return self.ts.shape[0]


def bars_of(ci: torch.Tensor):
    """``(first, counts, bar)`` of close indices ``ci`` (bar k holds trades
    ``ci[k] + 1 .. ci[k + 1]``): the first trade in any bar, each bar's
    trade count, and the bar of each trade from ``first`` on."""
    counts = ci[1:] - ci[:-1]
    bar = torch.repeat_interleave(torch.arange(counts.shape[0], device=ci.device), counts)
    return int(ci[0]) + 1, counts, bar


def seg_sum(x: torch.Tensor, bar: torch.Tensor, nb: int) -> torch.Tensor:
    out = torch.zeros(nb, dtype=x.dtype, device=x.device)
    return out.index_add_(0, bar, x)


def seg_ext(x: torch.Tensor, bar: torch.Tensor, nb: int, how: str, empty) -> torch.Tensor:
    """Per-bar ``amax``/``amin`` of ``x``; ``empty`` where a bar has none."""
    out = torch.full((nb,), empty, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, bar, x, how, include_self=True)


def sorted_in_bars(values: torch.Tensor, bar: torch.Tensor) -> torch.Tensor:
    """``values`` ascending within each bar, the bars in order (two stable
    sorts)."""
    o = torch.argsort(values, stable=True)
    o = o[torch.argsort(bar[o], stable=True)]
    return values[o]


def pair_to_f32(x: torch.Tensor) -> torch.Tensor:
    """int64 to float32 in steps, ``f32(hi) * 2^32 + (f32(lo) + 2^32 if lo
    < 0)`` with ``lo`` the signed low word, each step rounded in float32: the
    rounding the configuration's running-imbalance columns are stated in (the
    TPU kernels' ``_pair_to_f32`` of the original package)."""
    hi = (x >> 32).to(torch.float32)
    lo = (x & 0xFFFFFFFF) - ((x & 0x80000000) << 1)
    lo_f = lo.to(torch.float32)
    lo_f = torch.where(lo < 0, lo_f + 4294967296.0, lo_f)
    return hi * 4294967296.0 + lo_f
