"""FinMLKit on PyTorch and CUDA: the port of ``finmlkit_tpu`` to one NVIDIA H100.

Each module sits at the same relative path as its JAX counterpart in
``finmlkit_tpu/`` (one rename: ``ops/pallas_scan.py`` became
``ops/prefix_scan.py``). Functions take tensors on an explicit device; there is
no global configuration. The hot loops are CUDA C++ kernels in ``csrc/``,
compiled by ``nvcc`` for ``sm_90a`` at first use (``_build.py``) and bound with
``ctypes``:

- kernel **B** (``csrc/bar_products.cu``, ``ops.fused_scan``): per-bar OHLC,
  volume and dollar sums, directional counts, spreads and the in-bar imbalance
  extrema, one thread block per bar;
- kernel **S** (``csrc/prefix_scan.cu``, ``ops.prefix_scan``): inclusive prefix
  sums over int32, int64, float32 and float64 streams;
- kernel **C** (the same file, ``ops.prefix_scan.fast_cumsum_cols``): the
  prefix sums of every row of a ``(C, n)`` stack in one launch (the
  footprints' bar ids and lows, the trade-size unit sums).

A wrapper given a CPU tensor runs its kernel's plain PyTorch version; given a
CUDA tensor it launches the kernel or raises.

This package never imports JAX, pandas or ``finmlkit_tpu``.
"""
from ._version import __version__

__all__ = ["__version__"]
