"""Device milliseconds a pass of the trade-size features
(`bar/aggregate_q.py`): CUDA events around the stage's calls, summed over
the window and divided by its passes."""


def read(run):
    return run.stage_ms("trade_size")
