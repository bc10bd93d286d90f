"""Labels and sample weights: the triple-barrier method, the AFML sample
weights and the labelling kit."""
from .kit import SampleWeights, TBMLabel
from .tbm import triple_barrier
from .weights import (average_uniqueness, class_balance_weights, return_attribution,
                      time_decay)

__all__ = ["triple_barrier", "average_uniqueness", "return_attribution", "time_decay",
           "class_balance_weights", "TBMLabel", "SampleWeights"]
