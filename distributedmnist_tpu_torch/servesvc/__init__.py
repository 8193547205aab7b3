"""Online serving tier (≙ ``distributedmnist_tpu/servesvc``): a
:class:`~.server.ServingReplica` hot-follows a publish dir's
checkpoints (digest-verified; a torn publish is skipped, never served)
and answers one-shot classification requests over a local socket in
power-of-2 batches behind a bounded queue, swapping weights at a batch
boundary; a :class:`~.decode.DecodeReplica` streams generations over a
paged KV cache with the ``pin``/``restart`` mid-generation swap
policies; :class:`~.client.ServeClient` is the failover client and
:func:`~.loadgen.run_load` the closed-loop load generator."""

from .client import ServeClient, discover_endpoints
from .decode import DecodeReplica
from .kv_cache import BlockAllocator, PagedKVCache
from .loadgen import run_load
from .server import ServingReplica

__all__ = ["ServingReplica", "DecodeReplica", "ServeClient",
           "discover_endpoints", "run_load", "BlockAllocator",
           "PagedKVCache"]
