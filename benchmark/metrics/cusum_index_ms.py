"""Device milliseconds a pass of the CUSUM-bar index (`bar/indexers.py
cusum_bar_indexer` with the step's float64 prices and sigma column: the log
returns, kernel F's fill, the first valid sigma read, kernel E's CUSUM scan,
its count read): CUDA events around the stage's calls, summed over the
window and divided by its passes."""


def read(run):
    return run.stage_ms("cusum_index")
