"""The products stage's bytes (``bytecounts/products.py``) at the H100's published
3.35 TB/s over the stage's device time, in %."""
from harness import roofline_share


def read(run):
    return roofline_share(run, "products")
