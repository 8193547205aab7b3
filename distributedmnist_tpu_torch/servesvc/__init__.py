"""Online serving tier, decode path (≙ ``distributedmnist_tpu/servesvc``):
a :class:`~.decode.DecodeReplica` serves streaming generations over a
local socket from a published checkpoint, and :class:`~.client.
ServeClient` talks to it."""

from .client import ServeClient
from .decode import DecodeReplica
from .kv_cache import BlockAllocator, PagedKVCache

__all__ = ["DecodeReplica", "ServeClient", "BlockAllocator",
           "PagedKVCache"]
