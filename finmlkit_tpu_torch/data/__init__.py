"""The monthly HDF5 trade store and its 1-second klines (``h5py`` is imported
where a file is opened)."""
from .klines import AddTimeBarH5, TimeBarReader, build_klines, resample
from .store import H5Inspector, load_trades_h5, save_trades_h5

__all__ = ["save_trades_h5", "load_trades_h5", "H5Inspector", "AddTimeBarH5",
           "TimeBarReader", "build_klines", "resample"]
