"""repro_torch.data -- the port's OpenZL-compressed shard store, the
straggler-tolerant prefetcher and the synthetic generators."""
from .pipeline import Prefetcher, Straggler  # noqa: F401
from .shard_store import CompressedShardStore  # noqa: F401
