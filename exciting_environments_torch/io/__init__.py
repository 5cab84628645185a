"""Dataset IO (counterpart of ``exciting_environments_tpu/io``): shards
written asynchronously by a native writer, read back lazily, staged onto the
device ahead of the consumer.

* :class:`ShardWriter` streams trees into the JAX package's self-describing
  binary shard format through a C++ background writer thread (bounded
  queue, ``native/shard_writer.cpp``), so serialization overlaps the next
  rollout; without a host compiler a Python-thread writer with the same
  behaviour.  Both packages write the same bytes for the same data.
* :class:`ShardIndex` / :func:`read_shard_lazy` / :func:`read_shard`:
  footer-only indexing with memory-mapped payloads.
* :class:`DeviceLoader`: a background thread copies each entry into pinned
  memory and onto the device on a copy stream while the consumer still
  computes on the previous one.
* :class:`TorchShardDataset`: a map-style ``torch.utils.data.Dataset``.
"""

from exciting_environments_torch.io.dataset import ShardWriter, read_shard
from exciting_environments_torch.io.loader import DeviceLoader, ShardIndex, read_shard_lazy
from exciting_environments_torch.io.torch_data import TorchShardDataset

__all__ = ["DeviceLoader", "ShardIndex", "ShardWriter", "TorchShardDataset", "read_shard", "read_shard_lazy"]
