"""Host milliseconds a pass inside the five event indexers (the registry's
spans ``tick_bar_indexer``, ``volume_bar_indexer_q``, ``cusum_bar_indexer``,
``imbalance_bar_indexer`` and ``run_bar_indexer``, each called once a pass)
other than waiting in their reads from the card: each span's host time less
the time blocked in its reads, over its timed calls (the first call and the
calls under the profiler left out), summed. None where the program has no
such spans."""
from program_spans import spans

SPANS = ("tick_bar_indexer", "volume_bar_indexer_q", "cusum_bar_indexer",
         "imbalance_bar_indexer", "run_bar_indexer")


def read(run):
    rep = spans() or {}
    got = [rep[k] for k in SPANS if k in rep and rep[k]["timed"]]
    if len(got) < len(SPANS):
        return None
    return sum((v["host_ms"] - v["read_ms"]) / v["timed"] for v in got)
