"""Command-line tools: ``binance2h5`` (Binance monthly trades to the HDF5 store)."""
