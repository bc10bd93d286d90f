"""Device milliseconds a pass of the five bar sets' products (`bar/fused.py
bar_products_final`, once for each of the tick, volume, CUSUM, imbalance and
run bars): CUDA events around the stage's calls, summed over the window and
divided by its passes."""


def read(run):
    return run.stage_ms("event_products")
