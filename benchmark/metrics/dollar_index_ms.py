"""Device milliseconds a pass of the dollar-bar index in integer units
(`bar/indexers.py dollar_bar_indexer_q`): CUDA events around the stage's
calls, summed over the window and divided by its passes."""


def read(run):
    return run.stage_ms("dollar_index")
