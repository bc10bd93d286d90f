"""Host milliseconds a pass spends inside the layer entries other than
waiting in their reads from the card: over the entries' spans, each
entry's host time, its children's included, less the time blocked in its
reads, over its timed calls (the first call and the calls under the
profiler left out). Only the entries' time: the steps' own host work
between them (their glue, such as the time cell's mask of the CUSUM events)
is in no span and not counted."""
from program_spans import entries, spans


def read(run):
    ent = {k: v for k, v in entries(spans()).items() if v["timed"]}
    if not ent:
        return None
    return sum((v["host_ms"] - v["read_ms"]) / v["timed"] for v in ent.values())
