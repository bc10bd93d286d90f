"""The exact float64 volume and dollar bar walks: kernel D (``csrc/float_walk.cu``).

Kernel D replaces no TPU kernel. The JAX kits build volume and dollar bars of
trades whose prices sit on no tick grid with host C++ loops
(``finmlkit_tpu/native/seg_stats.cpp:183-211``); these walks are those loops,
close for close: the running sum starts with trade 0's value, the checks start
at trade 1, a bar closes at the first trade where the sum reaches the
threshold, and then volume restarts at 0 while dollar subtracts the threshold
(``cum -= thr``); at most ``max_bars`` closes are written.

Every step rounds once, as the source is written: ``p * (double)v`` is one
rounded product and the add another. A host build of the loops with
``-march=native`` fuses the dollar step into one FMA (ROADMAP R15), which can
move a close when the running sum lies within an ulp of the threshold; the
port follows the unfused source on the card and in the plain versions.

The plain versions are Python loops over ``.tolist()``: a serial float
recurrence has no vectorized form. They run in the tests and in
``chip_smoke.py``, not on the kits' path.
"""
from itertools import islice

import numpy as np
import torch

from .. import _build

__all__ = ["volume_walk", "volume_walk_plain", "dollar_walk", "dollar_walk_plain",
           "walk_blocks"]

LAUNCHES = 0   # kernel D launches in this process (volume and dollar)
_VOLUME, _DOLLAR = 0, 1
_CHUNK, _BLOCK = 2048, 16   # csrc/float_walk.cu


def _walk_plain(values: torch.Tensor, thr: float, max_bars: int, reset: bool):
    """The loop of ``seg_stats.cpp:183-211`` over float64 ``values`` (one per
    trade); returns the close indices as int64 on the values' device."""
    x = values.tolist()
    out = []
    if x and max_bars > 0:
        thr = float(thr)
        cum = x[0]
        for i, xi in enumerate(islice(x, 1, None), 1):
            cum += xi
            if cum >= thr:
                out.append(i)
                cum = 0.0 if reset else cum - thr
                if len(out) == max_bars:
                    break
    return torch.tensor(out, dtype=torch.int64, device=values.device)


def volume_walk_plain(volumes: torch.Tensor, thr: float, max_bars: int) -> torch.Tensor:
    """Plain version of :func:`volume_walk`, on any device."""
    return _walk_plain(volumes.to(torch.float64), thr, max_bars, reset=True)


def dollar_walk_plain(prices: torch.Tensor, volumes: torch.Tensor, thr: float,
                      max_bars: int) -> torch.Tensor:
    """Plain version of :func:`dollar_walk`, on any device. The products
    ``prices * volumes`` are formed first, each rounded once, as the kernel
    forms them."""
    return _walk_plain(prices.to(torch.float64) * volumes.to(torch.float64), thr,
                       max_bars, reset=False)


def walk_blocks(values, thr: float, max_bars: int, reset: bool, *, chunk: int = _CHUNK,
                block: int = _BLOCK):
    """Kernel D's walk on the CPU, for the tests: float64 ``values`` (numpy)
    cut into chunks of ``chunk`` and each chunk's values after the first
    trade into blocks of ``block``. A block whose values are all >= 0 and
    whose in-order sum stays below ``thr`` after its last value is added in
    one go; any other block, and a chunk's tail, is walked again a step at a
    time from the sum before it. Returns the closes and the number of blocks
    walked twice."""
    out, again = [], 0
    n = len(values)
    if n == 0 or max_bars <= 0:
        return np.asarray(out, np.int64), again
    x = values.tolist()
    cum = x[0]

    def step(i):
        nonlocal cum
        cum += x[i]
        if cum >= thr:
            out.append(i)
            cum = 0.0 if reset else cum - thr
        return len(out) == max_bars

    for base in range(0, n, chunk):
        m = min(chunk, n - base)
        j = 1 if base == 0 else 0
        while j + block <= m:
            xs = x[base + j:base + j + block]
            total = cum
            for xi in xs:
                total += xi
            if all(xi >= 0.0 for xi in xs) and total < thr:
                cum = total
            else:
                again += 1
                if any(step(base + j + u) for u in range(block)):
                    return np.asarray(out, np.int64), again
            j += block
        for i in range(base + j, base + m):
            if step(i):
                return np.asarray(out, np.int64), again
    return np.asarray(out, np.int64), again


def _check(what, volumes, prices=None):
    if volumes.dim() != 1 or volumes.dtype != torch.float32:
        raise TypeError(f"{what} takes 1-D float32 volumes, got {volumes.dtype} "
                        f"of shape {tuple(volumes.shape)}")
    if prices is not None and (prices.shape != volumes.shape
                               or prices.dtype != torch.float64
                               or prices.device != volumes.device):
        raise TypeError(f"{what} takes float64 prices of the volumes' shape and device")
    if volumes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {volumes.device}")


def _launch(mode: int, prices, volumes, thr: float, max_bars: int) -> torch.Tensor:
    """Kernel D over CUDA tensors; one device read for the number of closes."""
    global LAUNCHES
    dev = volumes.device
    n, max_bars = volumes.shape[0], int(max_bars)
    if n == 0 or max_bars <= 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    volumes = volumes.contiguous()
    prices = None if prices is None else prices.contiguous()
    out = torch.empty(max_bars, dtype=torch.int64, device=dev)
    count = torch.empty(1, dtype=torch.int64, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fmk_float_walk(mode, None if prices is None else prices.data_ptr(),
                                volumes.data_ptr(), n, float(thr), max_bars,
                                out.data_ptr(), count.data_ptr(), stream)
    _build.check(rc, "float_walk")
    LAUNCHES += 1
    return out[:int(count)]


def volume_walk(volumes: torch.Tensor, thr: float, max_bars: int) -> torch.Tensor:
    """Close indices (int64) of volume bars over float32 ``volumes``: the sum
    in float64 restarts at 0 at each close. On a CUDA tensor this launches
    kernel D; on a CPU tensor it runs :func:`volume_walk_plain`."""
    _check("volume_walk", volumes)
    if volumes.device.type == "cpu":
        return volume_walk_plain(volumes, thr, max_bars)
    return _launch(_VOLUME, None, volumes, thr, max_bars)


def dollar_walk(prices: torch.Tensor, volumes: torch.Tensor, thr: float,
                max_bars: int) -> torch.Tensor:
    """Close indices (int64) of dollar bars over float64 ``prices`` times
    float32 ``volumes``: the sum carries its remainder past each close. On
    CUDA tensors this launches kernel D; on CPU tensors it runs
    :func:`dollar_walk_plain`."""
    _check("dollar_walk", volumes, prices)
    if volumes.device.type == "cpu":
        return dollar_walk_plain(prices, volumes, thr, max_bars)
    return _launch(_DOLLAR, prices, volumes, thr, max_bars)
