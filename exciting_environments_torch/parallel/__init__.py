"""Batch split over devices and fleet metrics (counterpart of
``exciting_environments_tpu/parallel``).

The batch of an environment fleet splits into shards that run on their own
(:class:`ShardedEnv`); the only cross-shard work is the metric merge
(:mod:`~exciting_environments_torch.parallel.metrics`).
"""

from exciting_environments_torch.parallel.mesh import (
    BATCH_AXIS,
    ShardedEnv,
    batch_sharding,
    make_batch_mesh,
    replicated_sharding,
    shard_batched_tree,
)
from exciting_environments_torch.parallel.metrics import (
    RunningStats,
    gather_to_host,
    mean_metric,
    sum_metric,
    violation_fraction,
    Window,
    across_mesh,
    merge,
    running_init,
    running_summary,
    running_update,
    window_init,
    window_max,
    window_mean,
    window_min,
    window_push,
)
