"""Time-sharded bars over ``torch.distributed`` process groups: counterpart of
``finmlkit_tpu/parallel`` (``mesh``, ``sharded``, ``sharded_indexers``,
``sharded_footprint``, ``ingest``), with ``spawn_mesh`` to run local ranks and
``dryrun`` to drive the whole layer."""
from .mesh import spawn_mesh, time_mesh
from .ingest import load_months_parallel, load_store_to_mesh, month_plan
from .sharded import (
    shard_trades,
    sharded_bar_products,
    sharded_median_trade_size,
    sharded_segment_kth,
    sharded_trade_size_features,
)

__all__ = [
    "time_mesh",
    "spawn_mesh",
    "load_months_parallel",
    "load_store_to_mesh",
    "month_plan",
    "sharded_bar_products",
    "shard_trades",
    "sharded_median_trade_size",
    "sharded_segment_kth",
    "sharded_trade_size_features",
]
