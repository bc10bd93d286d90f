"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all of them at
once, and the objects are linked into ONE shared library with a plain C
interface, at first use, and loaded with ``ctypes``. The library goes to
``build/finmlkit_tpu_torch/`` beside the package, named by a hash of the
sources and flags, so a changed source builds anew and an unchanged one is
reused. There is no fallback: a missing ``nvcc`` or a failed build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "finmlkit_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_F64 = ctypes.c_double
# C entry points: name -> argtypes. Each returns cudaGetLastError() as int,
# but those of _SIZES, which return a number of bytes as int64.
_SIGNATURES = {
    "fmk_scan_scratch_bytes": [ctypes.c_int, _I64, _I64],
    "fmk_prefix_scan": [ctypes.c_int, _P, _P, _P, _I64, _P],
    "fmk_prefix_scan_rows": [ctypes.c_int, _P, _P, _P, _I64, _I64, _P],
    "fmk_products_scratch_bytes": [_I64, _I64],
    "fmk_bar_products": [_P] * 4 + [_I64, _I64] + [_P] * 4 + [ctypes.c_int, _P],
    "fmk_ffill_scratch_bytes": [_I64],
    "fmk_ffill": [ctypes.c_int, _P, _P, _P, _P, _I64, ctypes.c_int, _P],
    "fmk_event_scratch_bytes": [ctypes.c_int, _I64, _I64, _I64],
    "fmk_event_scan": [ctypes.c_int, _P, _P, _P, _P, _I64, _I64, _F64, _F64,
                       _F64, _F64, _I64, _P, _I64, _P, _I64, _P, _P, _P],
    "fmk_hist_pass": [_P, _P, _P, ctypes.c_int, _I64, _I64, _P, _P, _P],
    "fmk_less_pass": [_P, _P, _P, _I64, _I64, _P, _P, _P, _P],
    "fmk_planes_scratch_bytes": [_I64],
    "fmk_bar_planes": [_P] * 4 + [_I64, _I64] + [_P] * 5 + [ctypes.c_int, _P],
    "fmk_io_floor": [_P] * 8 + [ctypes.c_int, _P, _I64, _P],
    "fmk_io_floor_stacked": [_P, ctypes.c_int, _I64, _P, _P],
    "fmk_recurrence_scratch_bytes": [_I64, _I64],
    "fmk_linear_recurrence": [_P, _F64, _I64, ctypes.c_int, _P, _P, _P, _P, _I64,
                              _I64, _P, _P],
    "fmk_csw_sup_stat": [_P] * 5 + [_I64, _I64] + [_P] * 6,
    "fmk_profile_shared_levels": [],
    "fmk_volume_profile_rolling": [_P] * 5 + [_I64] * 4 + [ctypes.c_int, _F64, _I64,
                                                          ctypes.c_int, _I64] + [_P] * 9,
    "fmk_volume_profile_rows": [_P, _I64, _I64, _I64, ctypes.c_int, _F64, _I64, ctypes.c_int,
                                _I64] + [_P] * 8,
    "fmk_profile_walk_bytes": [],
    "fmk_profile_slots": [_P] * 3 + [_I64] * 4 + [_P] * 2,
    "fmk_profile_walk": [_P, _P, _I64, _I64, _I64, ctypes.c_int, _P, _P, _P],
}
_SIZES = {"fmk_scan_scratch_bytes", "fmk_event_scratch_bytes",
          "fmk_planes_scratch_bytes", "fmk_products_scratch_bytes",
          "fmk_ffill_scratch_bytes", "fmk_recurrence_scratch_bytes",
          "fmk_profile_shared_levels", "fmk_profile_walk_bytes"}

_lib = None
build_seconds = None  # wall time of the nvcc run in this process, if any
build_log = ""        # nvcc's output (ptxas register and spill report)


def nvcc_path() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        cands.append(Path(shutil.which("nvcc")))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfmk_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    global build_seconds, build_log
    srcs, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for src, obj in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
    if not failed:
        r = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                           capture_output=True, text=True)
        build_log += r.stdout + r.stderr
        failed = ["the link"] if r.returncode != 0 else []
    build_seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    out.with_suffix(".log").write_text(build_log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The kernel library, compiled on the first call of the process."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I64 if name in _SIZES else ctypes.c_int
        lib.fmk_error_string.argtypes = [ctypes.c_int]
        lib.fmk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().fmk_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
