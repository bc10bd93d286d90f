"""Kernel wrappers: ``prefix_scan`` (kernels S, C and F), ``fused_scan``
(kernels B, V and P), ``event_scan`` (kernel E), ``segment_hist`` (kernel H),
``scan`` (kernel R), and the segment operations and median engines built on
them."""
