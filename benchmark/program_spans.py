"""The program's trace registry (``finmlkit_tpu_torch/utils/trace.py``) as
the per-layer metrics read it. A run of ``run.py`` is one cell a process, so
the registry's figures are that cell's: its warm passes, the window and the
traced passes. A program without the registry gives None, and the metrics
that read it are left out of the result line."""


def spans():
    """``trace.report()`` of this process, or None without the registry."""
    try:
        from finmlkit_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.report()


def entries(report):
    """The spans only ever opened at top level: the layer entries that the
    steps call, each once a pass."""
    return {k: v for k, v in (report or {}).items() if v["calls"] and v["top"] == v["calls"]}
