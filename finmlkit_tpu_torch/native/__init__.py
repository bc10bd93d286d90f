"""Host C++ of the median engine ``medians="host"``, built with ``g++``.

Counterpart of ``seg_median_pair`` in ``finmlkit_tpu/native``, a copy of its
source (``seg_stats.cpp``): the two middle trade sizes of every bar by a
threaded ``nth_element``. ``g++`` builds it at first use into
``build/finmlkit_tpu_torch/`` beside the package, under a name hashed from
the source and the flags, and ``ctypes`` loads it. There is no fallback: a
missing ``g++`` or a failed build raises. The flags leave out ``-march=native``
(ROADMAP.md, Queue 3, R15), so the library does not depend on the machine that
builds it.

The JAX package's other host functions are not ported: ``seg_bar_stats``
serves only its TPU dispatch, ``cusum_filter_events`` is the port's own loop
(``sampling/filters.py``), and kernels E and D run the boundary loops.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from .._build import BUILD_DIR

__all__ = ["seg_median_pair", "library", "library_path", "THREADS"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "seg_stats.cpp")
FLAGS = ("-O3", "-std=c++17", "-pthread", "-fPIC", "-shared")
THREADS = max(len(os.sched_getaffinity(0)), 1)   # the threads a call splits its bars over

CALLS = 0   # seg_median_pair calls in this process

_lock = threading.Lock()
_lib = None


def library_path():
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(" ".join(FLAGS).encode() + f.read())
    return BUILD_DIR / f"libfmk_host_{h.hexdigest()[:16]}.so"


def _compile(out) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError('g++ not found on $PATH; medians="host" cannot be built')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, SOURCE, "-o", str(tmp)], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The host library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            lib.seg_median_pair.argtypes = [f32p, i64p, ctypes.c_int64, f32p, f32p,
                                            ctypes.c_int]
            lib.seg_median_pair.restype = None
            _lib = lib
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def seg_median_pair(vals: np.ndarray, ci: np.ndarray, threads: int = THREADS):
    """``(med_a, med_b)``, float32: the two middle values of ``vals`` over each
    bar ``(ci[i], ci[i+1]]``; 0 on empty bars. ``ci`` must lie in ``[-1,
    len(vals) - 1]`` and not decrease."""
    global CALLS
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    ci = np.ascontiguousarray(ci, dtype=np.int64)
    if ci.ndim != 1 or len(ci) == 0:
        raise ValueError("ci must be a 1-D array of at least one close index")
    if len(ci) > 1 and (ci[0] < -1 or ci[-1] >= len(vals) or np.any(np.diff(ci) < 0)):
        raise ValueError("ci must not decrease and must lie in [-1, len(vals) - 1]")
    n_bars = len(ci) - 1
    med_a = np.empty(n_bars, np.float32)
    med_b = np.empty(n_bars, np.float32)
    library().seg_median_pair(_ptr(vals, ctypes.c_float), _ptr(ci, ctypes.c_int64),
                              n_bars, _ptr(med_a, ctypes.c_float),
                              _ptr(med_b, ctypes.c_float), int(threads))
    CALLS += 1
    return med_a, med_b
