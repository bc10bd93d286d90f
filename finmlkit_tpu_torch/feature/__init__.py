"""Bar-level features: the feature framework (``Feature``, ``Compose``,
``FeatureKit``, the ``transforms`` catalog) and the array ``kernels`` of
``finmlkit_tpu/feature``, on frames that are dicts of tensors with the bars'
int64 ns close timestamps under ``"timestamp"`` (as the bar kits return
them)."""
from . import kernels, transforms
from .kit import Compose, Feature, FeatureKit

__all__ = ["Feature", "Compose", "FeatureKit", "transforms", "kernels"]
