"""repro_torch.data -- the port's OpenZL-compressed shard store."""
from .shard_store import CompressedShardStore  # noqa: F401
