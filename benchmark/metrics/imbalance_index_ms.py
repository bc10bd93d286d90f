"""Device milliseconds a pass of the tick imbalance-bar index
(`bar/indexers.py imbalance_bar_indexer`: the sides as float64 weights,
kernel E's map path, its count read): CUDA events around the stage's calls,
summed over the window and divided by its passes."""


def read(run):
    return run.stage_ms("imbalance_index")
