"""Device milliseconds a pass of the bar products (`bar/fused.py`: the bar
scan, the sort medians, the finals): CUDA events around the stage's calls,
summed over the window and divided by its passes."""


def read(run):
    return run.stage_ms("products")
