"""Device milliseconds a pass of the volume-bar index in integer units
(`bar/indexers.py volume_bar_indexer_q`: the units' total read, kernel E's
volume scan, its count read): CUDA events around the stage's calls, summed
over the window and divided by its passes."""


def read(run):
    return run.stage_ms("volume_index")
