"""Bars: quantization, indexers and the fused bar products."""
