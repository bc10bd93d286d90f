"""Host milliseconds of the footprint grid's memory check (the span
``check_grid_fits``, ``bar/footprint.py``; ``torch.cuda.mem_get_info`` on the
card) a ``bar_footprints`` call, over the timed calls (the first call and
the calls under the profiler left out)."""
from program_spans import spans


def read(run):
    rep = spans() or {}
    check, fp = rep.get("check_grid_fits"), rep.get("bar_footprints")
    if not check or not fp or not fp["timed"]:
        return None
    return check["host_ms"] / fp["timed"]
