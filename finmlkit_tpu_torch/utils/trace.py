"""The port's trace registry: spans, host reads and counters.

One registry for the whole package, switched like ``utils/log.py`` from the
environment: tracing is on where ``FMKT_TRACE=1`` is set at import, or after
:func:`enable`.

- :func:`span` names a layer entry (a context manager, or a decorator). Spans
  nest on a stack of each thread, so each knows its parent; a top-level span
  takes a new call id, which every span under it shares. Always, a span
  counts its calls and adds its host time (``time.perf_counter_ns``) to its
  name's totals, the first call of a name apart (it holds the kernel
  library's build or load and PyTorch's lazy loads), and nothing while a
  ``torch.profiler`` session records (its calls still count). With tracing
  on, a span also opens ``torch.profiler.record_function("fmkt.<name>")``,
  records a pair of CUDA events for its device time (read when the report is
  made) and keeps ``(name, parent, call id, start ns, end ns)`` in a ring of
  the last :data:`RING` spans. With tracing off none of these runs, so a
  profiler session sees no ``fmkt.`` range.
- :func:`host_read` is the one way an entry reads from the card (or copies
  to it from pageable memory, which also waits for the card): it counts the
  read, with the host time it blocked, against the innermost open span.
- :func:`count` adds to a counter, against the innermost span and the
  process: ``launch.<kernel>`` for each hand kernel's launch, and
  ``launch.<kernel>.<route or mode>`` beside it where a kernel has several;
  ``event_scan.regrow`` for each scan an event indexer runs again after its
  close buffer filled (``bar/indexers.py``).
- :func:`report` gives each span's figures, self and inclusive;
  :func:`dump` writes the ring's spans as JSON lines; :func:`counter` reads
  a counter's process total; :func:`reset` clears all.

It imports only ``torch`` and the standard library.
"""
import collections
import functools
import itertools
import json
import os
import threading
import time

import torch

__all__ = ["span", "host_read", "count", "counter", "enable", "disable", "enabled",
           "reset", "report", "dump", "RING"]

RING = 65536          # span records kept with tracing on (the most recent)
_PENDING = 4096       # event pairs held before the finished ones are read

_on = os.environ.get("FMKT_TRACE", "0") == "1"
_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled   # a torch.profiler session records
_local = threading.local()
_calls = itertools.count(1)
_stats = {}           # span name -> _Stat
_totals = {}          # counter name -> process total
_records = collections.deque(maxlen=RING)
_pending = collections.deque()   # (name, parent name, start event, end event)


class _Stat:
    __slots__ = ("calls", "top", "timed", "first_ns", "first_self_ns", "host_ns",
                 "self_ns", "reads", "self_reads", "read_ns", "self_read_ns", "counts",
                 "self_counts", "dev_n", "dev_ms", "self_dev_ms")

    def __init__(self):
        self.calls = self.top = self.timed = 0
        self.first_ns = self.first_self_ns = self.host_ns = self.self_ns = 0
        self.reads = self.self_reads = self.read_ns = self.self_read_ns = 0
        self.counts, self.self_counts = {}, {}
        self.dev_n, self.dev_ms, self.self_dev_ms = 0, 0.0, 0.0


class _Frame:
    """An open span: its name, parent frame and call id, whether it is timed
    (no profiler session at its start), its start ns and its children's ns,
    its own and its children's reads, read ns and counts (dicts, or None),
    and with tracing on its ``record_function`` and start event."""
    __slots__ = ("name", "parent", "call", "timed", "t0", "child_ns", "reads", "read_ns",
                 "child_reads", "child_read_ns", "counts", "child_counts", "rf", "ev")

    def __init__(self, name, parent):
        self.name, self.parent = name, parent
        self.call = next(_calls) if parent is None else parent.call
        self.timed = not _profiling()
        self.t0 = self.child_ns = self.reads = self.read_ns = 0
        self.child_reads = self.child_read_ns = 0
        self.counts = self.child_counts = self.rf = self.ev = None


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _add(into: dict, counts) -> None:
    if counts:
        for k, v in counts.items():
            into[k] = into.get(k, 0) + v


def _open(name: str) -> _Frame:
    st = _stack()
    f = _Frame(name, st[-1] if st else None)
    if _on:
        f.rf = torch.profiler.record_function("fmkt." + name)
        f.rf.__enter__()
        if torch.cuda.is_initialized():
            f.ev = torch.cuda.Event(enable_timing=True)
            f.ev.record()
    st.append(f)
    f.t0 = _clock()
    return f


def _close(f: _Frame) -> None:
    t1 = _clock()
    _stack().pop()                     # spans close in the order they opened
    name, p = f.name, f.parent
    ns = t1 - f.t0
    s = _stats.get(name)
    if s is None:
        s = _stats[name] = _Stat()
    reads, read_ns = f.reads + f.child_reads, f.read_ns + f.child_read_ns
    if s.calls == 0:
        s.first_ns += ns
        s.first_self_ns += ns - f.child_ns
    elif f.timed:
        s.timed += 1
        s.host_ns += ns
        s.self_ns += ns - f.child_ns
        s.read_ns += read_ns
        s.self_read_ns += f.read_ns
    s.calls += 1
    s.reads += reads
    s.self_reads += f.reads
    counted = f.counts or f.child_counts
    if counted:
        _add(s.self_counts, f.counts)
        _add(s.counts, f.counts)
        _add(s.counts, f.child_counts)
    if p is None:
        s.top += 1
    else:
        p.child_ns += ns
        p.child_reads += reads
        p.child_read_ns += read_ns
        if counted:
            if p.child_counts is None:
                p.child_counts = {}
            _add(p.child_counts, f.counts)
            _add(p.child_counts, f.child_counts)
    if f.rf is not None:
        parent = None if p is None else p.name
        if f.ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _pending.append((name, parent, f.ev, end))
            if len(_pending) > _PENDING:
                _resolve(wait=False)
        _records.append((name, parent, f.call, f.t0, t1))
        f.rf.__exit__(None, None, None)


class span:
    """``with span(name):`` or ``@span(name)``: a span over the block or each
    call of the function (see the module's docstring)."""
    __slots__ = ("name", "_frame")

    def __init__(self, name: str):
        self.name, self._frame = name, None

    def __enter__(self):
        self._frame = _open(self.name)
        return self

    def __exit__(self, *exc):
        _close(self._frame)
        self._frame = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            f = _open(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _close(f)
        return spanned


def host_read(fn, x, n: int = 1):
    """``fn(x)``, a read from the card (``bool``, ``int``, ``float``,
    ``torch.Tensor.cpu``, ``.item``, ``.tolist`` ...), counted against the
    innermost open span with the host time it blocked (outside every span it
    counts nowhere); ``n`` is the reads ``fn`` makes where it makes more
    than one (a library call that checks its input on the host)."""
    t0 = _clock()
    v = fn(x)
    ns = _clock() - t0
    st = _stack()
    if st:
        f = st[-1]
        f.reads += n
        f.read_ns += ns
    return v


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, for the process and the innermost span."""
    _totals[name] = _totals.get(name, 0) + n
    st = _stack()
    if st:
        f = st[-1]
        if f.counts is None:
            f.counts = {name: n}
        else:
            f.counts[name] = f.counts.get(name, 0) + n


def counter(name: str) -> int:
    """Counter ``name``'s process total (0 if never counted)."""
    return _totals.get(name, 0)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every span's figures, the counters, the records and the
    events not read yet; open spans close into the fresh registry."""
    _stats.clear()
    _totals.clear()
    _records.clear()
    _pending.clear()


def _resolve(wait: bool) -> None:
    """Add the device time of the recorded event pairs to their spans (self
    time leaves out the direct children's); without ``wait`` only those the
    card has finished, in order."""
    while _pending:
        name, parent, a, b = _pending[0]
        if wait:
            b.synchronize()
        elif not b.query():
            return
        _pending.popleft()
        ms = a.elapsed_time(b)
        s = _stats.get(name)
        if s is not None:
            s.dev_n += 1
            s.dev_ms += ms
            s.self_dev_ms += ms
        if parent is not None and parent in _stats:
            _stats[parent].self_dev_ms -= ms


def _split(counts: dict):
    launches = {k: v for k, v in counts.items() if k.startswith("launch.")}
    return launches, {k: v for k, v in counts.items() if k not in launches}


def report() -> dict:
    """Each span name's figures: ``calls`` (``top`` of them at top level),
    ``first_ms`` and ``self_first_ms`` (the first call's host time),
    ``timed`` (the calls after the first outside a profiler session) and
    their ``host_ms``, the ``reads`` of all calls and the ``read_ms`` they
    blocked in the timed calls, ``launches`` by kernel and other ``counts``,
    and, with tracing on, ``device_ms``; each inclusive, and as ``self_...``
    without its spans' children."""
    _resolve(wait=True)
    out = {}
    for name, s in list(_stats.items()):
        launches, counts = _split(s.counts)
        self_launches, self_counts = _split(s.self_counts)
        on = s.dev_n > 0
        out[name] = {
            "calls": s.calls, "top": s.top, "timed": s.timed,
            "first_ms": s.first_ns / 1e6, "self_first_ms": s.first_self_ns / 1e6,
            "host_ms": s.host_ns / 1e6, "self_host_ms": s.self_ns / 1e6,
            "reads": s.reads, "self_reads": s.self_reads,
            "read_ms": s.read_ns / 1e6, "self_read_ms": s.self_read_ns / 1e6,
            "launches": launches, "self_launches": self_launches,
            "counts": counts, "self_counts": self_counts,
            "device_ms": s.dev_ms if on else None,
            "self_device_ms": s.self_dev_ms if on else None,
        }
    return out


def dump(path) -> int:
    """Write the ring's span records to ``path``, one JSON object a line
    (``name``, ``parent``, ``call``, ``start_ns``, ``end_ns``, on the host's
    ``perf_counter_ns`` clock), oldest first; returns how many."""
    rows = list(_records)
    with open(path, "w") as fh:
        for name, parent, call, t0, t1 in rows:
            fh.write(json.dumps({"name": name, "parent": parent, "call": call,
                                 "start_ns": t0, "end_ns": t1}) + "\n")
    return len(rows)
