"""Device milliseconds a pass of the triple-barrier labels and the sample
weights (`label/tbm.py`, `label/weights.py`): CUDA events around the stage's
calls, summed over the window and divided by its passes."""


def read(run):
    return run.stage_ms("labels")
