"""Process groups over the time axis of a trade stream.

Counterpart of ``finmlkit_tpu/parallel/mesh.py``. The JAX package builds a 1-D
device mesh over the time axis (and optionally a second axis over symbols);
here the unit is a rank of a ``torch.distributed`` process group, one rank per
device, and every sharded function runs on each rank of an initialized group
(SPMD). A :class:`TimeMesh` names the group, the rank, the world size and the
device the rank computes on.

:func:`spawn_mesh` runs a function on local ranks, started with the ``spawn``
method on a ``FileStore`` in a temporary directory (no TCP port, so that
several test workers do not collide), every group with a timeout, and joins
them by a deadline: a rank that raises or a collective that hangs fails the
call within the deadline, and every rank still alive is killed.

The collectives of the sharded functions go through :func:`all_reduce`,
:func:`broadcast` and :func:`all_gather`, which count the bytes they move
(``BYTES``). NCCL takes two ranks on one GPU nowhere, so several ranks that
share one card run on ``gloo``; where gloo refuses a collective on CUDA
tensors, these helpers stage it through pinned host memory
(``GLOO_CUDA_REFUSED``, the calls to stage), for gloo and CUDA tensors only.
A world-size-1 ``nccl`` group runs the same functions, its host tensors moved
to the card.
"""
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

__all__ = ["TimeMesh", "SymbolTimeMesh", "time_mesh", "symbol_time_mesh", "spawn_mesh",
           "all_reduce", "broadcast", "all_gather", "BYTES", "GLOO_CUDA_REFUSED"]

BYTES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0, "staged": 0}
# gloo collectives staged through host memory on CUDA tensors. On the H100
# host (torch 2.11, CUDA 12.8) gloo took all_reduce (sum, min, max),
# broadcast and the list all_gather on CUDA tensors, so none is staged by
# default; chip_smoke.py phase 14 checks that again and runs one sharded
# indexer with all three staged.
GLOO_CUDA_REFUSED = set()
DEFAULT_TIMEOUT = 120.0       # seconds a collective may wait


@dataclass(frozen=True)
class TimeMesh:
    """One rank of a group over the time axis: trades ``span(n)[0] ..
    span(n)[1] - 1`` of a stream of ``n`` are this rank's by default."""
    group: object              # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device
    backend: str

    def span(self, n: int, rank: int | None = None) -> tuple:
        """The even contiguous split of ``n`` trades: rank r's ``(lo, hi)``."""
        r = self.rank if rank is None else rank
        return n * r // self.size, n * (r + 1) // self.size


@dataclass(frozen=True)
class SymbolTimeMesh:
    """A rank of a (symbol x time) grid: its symbol row and the time mesh of
    that row's ranks."""
    symbol: int
    n_symbol: int
    time: TimeMesh


def _device(rank: int, device) -> torch.device:
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a time mesh on cuda needs a CUDA device; pass device='cpu' "
                           "for the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def time_mesh(group=None, device=None) -> TimeMesh:
    """The time mesh of this process in ``group`` (the default group when
    None), which must be initialized. The device is ``cuda:{LOCAL_RANK}``
    (modulo the visible devices, so that several ranks can share one card)
    unless ``device`` names one, ``"cpu"`` for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call "
                           "init_process_group (or spawn_mesh) first")
    rank = dist.get_rank(group)
    return TimeMesh(group, rank, dist.get_world_size(group), _device(rank, device),
                    dist.get_backend(group))


def symbol_time_mesh(n_symbol: int, n_time: int, device=None,
                     timeout: float = DEFAULT_TIMEOUT) -> SymbolTimeMesh:
    """A (symbol x time) grid of the default group's ``n_symbol * n_time``
    ranks, row-major: rank ``s * n_time + t`` takes symbol ``s`` and the
    ``t``-th span of its stream. Every rank creates every row's group
    (``dist.new_group`` is collective)."""
    world = dist.get_world_size()
    if world != n_symbol * n_time:
        raise ValueError(f"{n_symbol} x {n_time} ranks asked of a group of {world}")
    rank = dist.get_rank()
    mine = None
    for s in range(n_symbol):
        g = dist.new_group(list(range(s * n_time, (s + 1) * n_time)),
                           timeout=datetime.timedelta(seconds=timeout))
        if s == rank // n_time:
            mine = g
    return SymbolTimeMesh(rank // n_time, n_symbol, time_mesh(mine, device))


# --- collectives ------------------------------------------------------------


def _run(mesh: TimeMesh, name: str, t: torch.Tensor, call):
    """Run ``call(tensor)`` on ``t`` where the backend takes it: host
    tensors of an nccl group go to its device; CUDA tensors of a gloo group
    go through pinned host memory for the calls gloo refuses. Returns the
    tensor the call wrote, on ``t``'s device."""
    if mesh.backend == "nccl" and t.device.type != "cuda":
        return call(t.to(mesh.device)).to(t.device)
    if mesh.backend == "gloo" and t.device.type == "cuda" and name in GLOO_CUDA_REFUSED:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        BYTES["staged"] += t.numel() * t.element_size()
        return call(host).to(t.device)
    return call(t)


def all_reduce(mesh: TimeMesh, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum", "min" or "max") of ``t`` over the
    group's ranks, returned on every rank."""
    how = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    BYTES["all_reduce"] += t.numel() * t.element_size()

    def call(x):
        x = x.contiguous().clone()
        dist.all_reduce(x, op=how, group=mesh.group)
        return x
    return _run(mesh, "all_reduce", t, call)


def broadcast(mesh: TimeMesh, t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` (a rank of the mesh) on every rank; every rank
    passes a tensor of the same shape and dtype."""
    BYTES["broadcast"] += t.numel() * t.element_size()

    def call(x):
        x = x.contiguous().clone()
        dist.broadcast(x, src=dist.get_global_rank(mesh.group, src)
                       if mesh.group is not None else src, group=mesh.group)
        return x
    return _run(mesh, "broadcast", t, call)


def all_gather(mesh: TimeMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), stacked in rank order: ``(size,
    *t.shape)``."""
    BYTES["all_gather"] += t.numel() * t.element_size() * mesh.size

    def call(x):
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(mesh.size)]
        dist.all_gather(out, x, group=mesh.group)
        return torch.stack(out)
    return _run(mesh, "all_gather", t, call)


# --- local ranks --------------------------------------------------------------


def _to_host(x):
    """``x`` with every tensor a numpy array: tensors on a queue would pass
    shared-memory handles that die with the rank."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, args, rank, world, backend, device, store, timeout, results):
    """A spawned rank: join the group, run ``fn(mesh, *args)`` and put
    ``(rank, ok, result or traceback)`` on ``results``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout))
        mesh = time_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        results.put((rank, True, _to_host(fn(mesh, *args))))
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(fn, world: int, *, args=(), backend: str = "gloo", device="cuda",
               timeout: float = DEFAULT_TIMEOUT, deadline: float | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world`` local ranks and return their
    results in rank order (tensors as numpy arrays).

    ``fn`` must live in an importable module (not ``__main__`` or a test
    file): the ranks start with the ``spawn`` method and import it. They
    join a group of ``backend`` on a ``FileStore`` in a temporary directory,
    with ``timeout`` seconds for each collective, on ``device`` ("cuda": rank
    r on ``cuda:{r % device_count}``; "cpu"). The parent builds the kernel
    library first where the ranks run on a card, so that they load it rather
    than each running ``nvcc``. Raises ``RuntimeError`` with the rank's
    traceback where a rank raises, dies or has not finished ``deadline``
    seconds after the start (default ``2 * timeout + 60``); every rank still
    running then is killed."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn_mesh on cuda needs a CUDA device")
        from .. import _build
        _build.library()
    ctx = multiprocessing.get_context("spawn")
    limit = time.monotonic() + (2 * timeout + 60 if deadline is None else deadline)
    with tempfile.TemporaryDirectory(prefix="fmk_mesh_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, args, r, world, backend, str(device),
                                   os.path.join(tmp, "store"), timeout, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        done, failed = {}, None
        try:
            while len(done) < world and failed is None:
                left = limit - time.monotonic()
                if left <= 0:
                    failed = (f"ranks {sorted(set(range(world)) - set(done))} did not "
                              f"finish within the deadline")
                    break
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        failed = f"rank {dead[0]} died with exit code {procs[dead[0]].exitcode}"
                    continue
                if ok:
                    done[rank] = payload
                else:
                    failed = f"rank {rank} raised:\n{payload}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
            results.close()
    if failed is not None:
        raise RuntimeError(f"spawn_mesh({getattr(fn, '__name__', fn)}, {world} ranks on "
                           f"{backend}): {failed}")
    return [done[r] for r in range(world)]
