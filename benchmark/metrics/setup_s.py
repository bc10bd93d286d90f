"""Process start to the window's start: the month drawn from the seed, its
quantization and copy to the card, the kernels' build or load, the warm
passes."""


def read(run):
    return run.setup_s
