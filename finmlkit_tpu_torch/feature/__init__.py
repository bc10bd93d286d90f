"""Bar-level features: the array kernels of ``finmlkit_tpu/feature/kernels``.

The feature framework of the JAX package (``Feature``, ``Compose``,
``FeatureKit``, ``transforms``) is not ported yet; ``kernels`` is.
"""
from . import kernels

__all__ = ["kernels"]
