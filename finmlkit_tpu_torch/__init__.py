"""FinMLKit on PyTorch and CUDA: the port of ``finmlkit_tpu`` to one NVIDIA H100.

Each module sits at the same relative path as its JAX counterpart in
``finmlkit_tpu/`` (one rename: ``ops/pallas_scan.py`` became
``ops/prefix_scan.py``). Functions take tensors on an explicit device; there is
no global configuration. The hot loops are CUDA C++ kernels in ``csrc/``,
compiled by ``nvcc`` for ``sm_90a`` at first use (``_build.py``) and bound with
``ctypes``:

- kernel **B** (``csrc/bar_products.cu``, ``ops.fused_scan``): per-bar OHLC,
  volume and dollar sums, directional counts, spreads and the in-bar imbalance
  extrema, one pass over fixed tiles of trades;
- kernel **S** (``csrc/prefix_scan.cu``, ``ops.prefix_scan``): inclusive prefix
  sums over int32, int64, float32 and float64 streams;
- kernel **C** (the same file, ``ops.prefix_scan.fast_cumsum_cols``): the
  prefix sums of every row of a ``(C, n)`` stack in one launch (the
  footprints' bar ids and lows, the trade-size unit sums);
- kernel **F** (``csrc/ffill.cu``, ``ops.prefix_scan.fast_ffill``): the
  forward fill of the CUSUM bars' sigma;
- kernel **E** (``csrc/event_scan.cu``, ``ops.event_scan``): the CUSUM,
  imbalance, run and volume bar boundary scans, one call each; imbalance bars
  at a fixed threshold on integer weights as a parallel scan of the tiles'
  maps of in-bar states;
- kernel **H** (``csrc/segment_hist.cu``, ``ops.segment_hist``): the
  per-bar histogram and "less" passes of the hist median engine, one pass
  over fixed tiles of trades;
- kernel **V** (``csrc/bar_planes.cu``, ``ops.fused_scan.bar_scan_planes``):
  the full planes, every trade's prefixes and in-bar running extrema, as one
  segmented scan over fixed tiles of trades;
- kernel **P** (``csrc/io_floor.cu``, ``ops.fused_scan.bar_scan_io_floor``):
  the streaming-floor probes;
- kernel **R** (``csrc/recurrence.cu``, ``ops.scan.linear_recurrence``): the
  float64 linear recurrences ``y_t = a_t y_{t-1} + b_t`` of the feature
  kernels (EWMA, EWM variances, Wilder's RSI, ATR, ADX);
- kernel **W** (``csrc/csw.cu``, ``feature.kernels.structural_break``): the
  sup statistic of the CSW CUSUM structural-break test, a warp per t;
- kernel **Z** (``csrc/cusum_filter.cu``, ``sampling.filters.cusum_filter``):
  the CUSUM event filter, exact, in one block whose walkers' chunks meet in
  rounds.

Kernel F's int32 mode (``ops.prefix_scan.fill_last``) serves the radix-select
median engine (``ops.segment_select``).

A wrapper given a CPU tensor runs its kernel's plain PyTorch version; given a
CUDA tensor it launches the kernel or raises.

The user-facing chain: ``bar.TradesData`` (raw trades and their
preprocessing), the bar kits (``bar.TimeBarKit`` and the others), the
feature framework (``feature.FeatureKit``), ``pipeline`` (bars -> features
on the device, one readback), ``sampling`` (``cusum_filter``, kernel Z and
one read of its count on the card, ``z_score_peak_filter``) and ``label`` (``TBMLabel``, ``SampleWeights``).

The host-only layers: ``data`` (the monthly HDF5 trade store in the JAX
package's layout, and the 1-second klines built and resampled on the card),
``cli.binance2h5`` (Binance's monthly trades into the store), ``utils.log``
(the ``FMKT_*`` logger) and ``native`` (the host C++ of ``medians="host"``).
``h5py`` is imported only where a file is opened.

The parallel layer (``parallel``): the indexers, bar products, order
statistics, footprints and store ingest across the ranks of a
``torch.distributed`` group, one rank a device, each on a contiguous span of
the trades (``spawn_mesh`` runs local ranks).

This package never imports JAX, pandas or ``finmlkit_tpu``.
"""
from ._version import __version__
from . import pipeline

__all__ = ["__version__", "pipeline"]
