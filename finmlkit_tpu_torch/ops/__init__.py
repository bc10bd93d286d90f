"""Kernel wrappers: ``prefix_scan`` (kernel S) and ``fused_scan`` (kernel B)."""
