"""Device milliseconds a pass of the tick run-bar index (`bar/indexers.py
run_bar_indexer`: the sides as float64 weights, kernel E's walk with the EMA
threshold, its count read): CUDA events around the stage's calls, summed
over the window and divided by its passes."""


def read(run):
    return run.stage_ms("run_index")
