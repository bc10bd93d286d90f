"""Device milliseconds a pass of the time-bar index (`bar/indexers.py
time_bar_indexer`): CUDA events around the stage's calls, summed over the
window and divided by its passes."""


def read(run):
    return run.stage_ms("time_index")
