"""Times a pass's five event indexers stop the host to read from the card
(``trace.host_read``: the volume units' total, the CUSUM index's first valid
sigma, kernel E's count, and a count again for each scan after a full close
buffer): each span's reads over its calls (all calls counted, the profiled
ones too), summed over the spans ``event_host_ms`` reads. None where the
program has no such spans."""
from program_spans import spans

SPANS = ("tick_bar_indexer", "volume_bar_indexer_q", "cusum_bar_indexer",
         "imbalance_bar_indexer", "run_bar_indexer")


def read(run):
    rep = spans() or {}
    got = [rep[k] for k in SPANS if k in rep and rep[k]["calls"]]
    if len(got) < len(SPANS):
        return None
    return sum(v["reads"] / v["calls"] for v in got)
