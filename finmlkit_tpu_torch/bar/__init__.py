"""Bars: the trades and their preprocessing, quantization, indexers, the fused
bar products, the float64 path of trades on no tick grid, footprints and the
kits."""
from .data_model import FootprintData, TradesData
from .kit import (CUSUMBarKit, DollarBarKit, ImbalanceBarKit, RunBarKit, TickBarKit,
                  TimeBarKit, VolumeBarKit)

__all__ = ["TimeBarKit", "TickBarKit", "VolumeBarKit", "DollarBarKit", "CUSUMBarKit",
           "ImbalanceBarKit", "RunBarKit", "TradesData", "FootprintData"]
