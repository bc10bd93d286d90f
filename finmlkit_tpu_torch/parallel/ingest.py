"""Loading a monthly trade store into the ranks of a time mesh.

Counterpart of ``finmlkit_tpu/parallel/ingest.py``, on the port's HDF5 store
(``data/store.py``, the JAX package's layout):

- **the row plan**: each rank owns a contiguous span of rows, one rank a
  device, here as each JAX process owns its devices' span. The months' record
  counts come from the store's ``/meta`` groups, so the plan reads no data; a
  rank loads only the months that overlap its span (memory ``O(total / ranks
  + a straddling month)``; nothing is gathered).
- **the load**: each rank reads its months with its own file handles in a
  process pool (``spawn``), in turn where the pool fails, as the reference
  does.
- **the placement**: a rank moves its own rows to its own device (the JAX
  package builds a global array from per-host callbacks,
  ``make_array_from_callback``); nothing is padded.

``h5py`` is imported where a file is opened.
"""
import concurrent.futures
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.store import _h5py, _load_single_group, _pool
from ..utils.log import get_logger
from .mesh import TimeMesh
from .sharded import TradeShard, _tensor

__all__ = ["month_plan", "row_plan", "load_months_parallel", "load_store_to_mesh"]

logger = get_logger(__name__)

_COLS = ("timestamp", "price", "amount", "side")
_DTYPES = {"timestamp": np.int64, "price": np.float64, "amount": np.float32, "side": np.int8}


def month_plan(months: Sequence[str], n_processes: int) -> List[List[str]]:
    """Contiguous month -> process assignment in time order, even by month
    count (:func:`row_plan` splits by rows where the counts are known)."""
    months = sorted(months)
    n = len(months)
    bounds = [round(p * n / n_processes) for p in range(n_processes + 1)]
    return [months[bounds[p]:bounds[p + 1]] for p in range(n_processes)]


def row_plan(month_counts: Dict[str, int], n_processes: int,
             n_padded: Optional[int] = None) -> Tuple[List[dict], List[Tuple[int, int]]]:
    """Which months and rows each process loads for a contiguous split of the
    stream into ``n_processes`` spans of ``n_padded`` rows (default the
    total; the JAX package passes its padded length).

    :param month_counts: ``{month_key: record_count}``.
    :returns: (per-process plans, per-process ``(row_start, row_end)``). A
        plan is ``{"months": [...], "skip": rows to drop from the first
        month, "take": real rows in the span}``."""
    months = sorted(month_counts)
    counts = np.array([month_counts[m] for m in months], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    total = int(offsets[-1])
    n_pad = total if n_padded is None else int(n_padded)
    spans = [(p * n_pad // n_processes, (p + 1) * n_pad // n_processes)
             for p in range(n_processes)]
    plans = []
    for lo, hi in spans:
        lo_c, hi_c = min(lo, total), min(hi, total)
        first = max(int(np.searchsorted(offsets, lo_c, side="right")) - 1, 0)
        last = max(int(np.searchsorted(offsets, max(hi_c - 1, lo_c), side="right")) - 1,
                   first)
        sel = months[first:last + 1] if hi_c > lo_c else []
        plans.append({"months": sel, "skip": int(lo_c - offsets[first]) if sel else 0,
                      "take": int(hi_c - lo_c)})
    return plans, spans


def load_months_parallel(filepath: str, months: Sequence[str], max_workers: int = 4) -> dict:
    """The columns of ``months`` concatenated in time order, the months read
    in a process pool (in turn where the pool fails). A column that some
    months lack raises ``ValueError``: it would misalign the stream."""
    months = sorted(months)
    results = {}
    if max_workers > 1 and len(months) > 1:
        try:
            with _pool(max_workers) as ex:
                futs = {ex.submit(_load_single_group, filepath, m): m for m in months}
                for fut in concurrent.futures.as_completed(futs):
                    results[futs[fut]] = fut.result()
        except Exception as e:  # noqa: BLE001 - the pool failed: load the months in turn
            logger.warning(f"Parallel month load failed ({e}); sequential fallback.")
            results = {}
    if not results:
        for m in months:
            results[m] = _load_single_group(filepath, m)
    cols = {}
    for name in _COLS:
        have = [m for m in months if name in results[m]]
        if not have:
            continue
        if len(have) != len(months):
            missing = [m for m in months if name not in results[m]]
            raise ValueError(
                f"column {name!r} present in months {have} but missing in "
                f"{missing}; a partially-present column would silently "
                f"misalign the concatenated stream")
        cols[name] = np.concatenate([results[m][name] for m in months])
    return cols


def _month_counts(filepath: str, months: Sequence[str]) -> Dict[str, int]:
    """Each month's record count from its ``/meta`` group, or its timestamp
    column's length (no data read)."""
    counts = {}
    with _h5py().File(filepath, "r") as f:
        for m in months:
            mk = f"meta/{m}"
            if mk in f and "record_count" in f[mk].attrs:
                counts[m] = int(f[mk].attrs["record_count"])
            else:
                counts[m] = int(f[f"trades/{m}/timestamp"].shape[0])
    return counts


def load_store_to_mesh(filepath: str, mesh: TimeMesh, *,
                       months: Optional[Sequence[str]] = None, max_workers: int = 4):
    """Load a monthly trade store into the mesh's ranks, each rank its own
    contiguous span of rows on its own device.

    :param months: month keys (default: every month of the store; all ranks
        must agree).
    :returns: ``(trades, n_trades, local)``: this rank's :class:`TradeShard`
        (``timestamp``, ``price``, ``amount`` and ``side`` on the mesh's
        device), the stream's trade count, and this rank's host columns."""
    if months is None:
        with _h5py().File(filepath, "r") as f:
            months = sorted(f["trades"].keys())
    counts = _month_counts(filepath, sorted(months))
    total = int(sum(counts.values()))
    plans, spans = row_plan(counts, mesh.size)
    my = plans[mesh.rank]
    local = (load_months_parallel(filepath, my["months"], max_workers) if my["months"]
             else {k: np.zeros(0, dt) for k, dt in _DTYPES.items()})   # an empty span
    local = {k: np.ascontiguousarray(v[my["skip"]:my["skip"] + my["take"]])
             for k, v in local.items()}
    cols = {k: _tensor(v, mesh.device) for k, v in local.items()}
    return TradeShard(cols, mesh.rank, total, tuple(spans)), total, local
