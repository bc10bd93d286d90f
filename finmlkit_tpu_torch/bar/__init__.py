"""Bars: the trades and their preprocessing, quantization, indexers, the fused
bar products and the kits."""
from .data_model import TradesData
from .kit import (CUSUMBarKit, DollarBarKit, ImbalanceBarKit, RunBarKit, TickBarKit,
                  TimeBarKit, VolumeBarKit)

__all__ = ["TimeBarKit", "TickBarKit", "VolumeBarKit", "DollarBarKit", "CUSUMBarKit",
           "ImbalanceBarKit", "RunBarKit", "TradesData"]
