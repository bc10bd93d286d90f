"""The four kernel-E stages' least bytes (``bytecounts/event_scans.py``) at
the H100's published 3.35 TB/s over the stages' summed device time, in %."""
import peaks

STAGES = ("volume_index", "cusum_index", "imbalance_index", "run_index")


def read(run):
    ms = [run.stage_ms(s) for s in STAGES]
    if None in ms or sum(ms) <= 0:
        return None
    return 100.0 * run.count_bytes("event_scans") / peaks.HBM_BYTES_PER_S / (sum(ms) / 1e3)
