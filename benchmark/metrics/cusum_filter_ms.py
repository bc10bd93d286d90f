"""Milliseconds a pass of the CUSUM filter (``sampling/filters.py``, a loop
on the host; its read of the closes included): host clock around the call
after a synchronize, summed over the window and divided by its passes."""


def read(run):
    return run.stage_ms("cusum_filter")
