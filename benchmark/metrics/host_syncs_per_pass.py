"""Times a pass's program entries stop the host to read from the card
(``trace.host_read`` in the program, a synchronizing copy either way): over
the layer entries' spans, each entry's reads, its children's included, over
its calls (every entry runs once a pass; all calls counted, the profiled
ones too). Only the entries' reads: a read of the steps between them (the
time cell's boolean mask of the CUSUM events in ``steps/cusum_events.py``)
is in no span and not counted, nor is an entry's second call in a pass."""
from program_spans import entries, spans


def read(run):
    ent = entries(spans())
    if not ent:
        return None
    return sum(v["reads"] / v["calls"] for v in ent.values())
