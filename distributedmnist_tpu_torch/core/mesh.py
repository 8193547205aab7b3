"""The replica topology (≙ ``distributedmnist_tpu/core/mesh.py``
``initialize_distributed``, ``Topology`` and ``make_topology``), for
data parallelism.

The reference lays its replicas over a device mesh and runs one SPMD
program across them, on one process or several. The port runs ``n``
replicas split evenly over ``P`` processes (``P = 1`` without a process
group: the analogue of the reference's forced ``n``-device CPU mesh).
Process ``p`` holds replicas ``[p·L, (p+1)·L)``, ``L = n / P``, all on
its one device; each replica takes its own row block of the process's
batch, its own dropout and straggler keys (by global replica index),
and its own gradient; only the cross-replica operations below combine
them.

Those operations are the only place replicas meet, and each takes a
leading axis of this process's ``L`` replicas:
:meth:`Topology.sum_replicas` (the masked mean's one all-reduce),
:meth:`Topology.gather_scalars` (per-replica rows into ``[n]``, the
reference's one-hot psum), and the ZeRO-1 pair
:meth:`Topology.reduce_scatter_replicas` (≙ ``lax.psum_scatter``) and
:meth:`Topology.all_gather_replicas` (≙ ``gather_bucket_replicated``).
With a process group each ends in one collective — NCCL on the card,
gloo on the CPU — and nothing else, so a gloo group can run them on
CUDA tensors too; a backend that lacks one raises. Host tensors (the
measured ``[n]`` times, the eval sums) go through a second, gloo, group:
an NCCL group cannot reduce CPU tensors.

:func:`initialize_distributed` makes the group from ``torchrun``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` — PyTorch's form of the reference's
``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``);
without ``WORLD_SIZE`` it does nothing and :func:`make_topology` builds
the one-process topology.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import time
from typing import Any

import torch
import torch.distributed as dist

from .config import MeshConfig
from .device import resolve_device

# the gloo group host tensors reduce over; None with a gloo default
# group (the default group is gloo already) or without a group
_host_group: Any = None


def local_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over dim 0 left to right, one float add an element a
    row: the same order for every element whatever the other dims (a
    ``sum(0)`` reduction orders its adds by the tensor's width and the
    backend), so two layouts of the same addends sum bitwise alike."""
    out = x[0].clone()
    for j in range(1, x.shape[0]):
        out.add_(x[j])
    return out


@dataclasses.dataclass
class Topology:
    """``num_replicas`` data-parallel replicas split evenly over
    ``process_count`` processes; this one is ``process_index`` and holds
    replicas ``[first_replica, first_replica + local_replica_count)`` on
    the device its state lives on. ``distributed`` is set when a process
    group is up (even of one process): the sums then run through it.
    ``blocked_s`` counts the host seconds this process spent inside
    collectives, waiting for its peers included (the Trainer takes them
    out of its measured step time, as the reference's device-side
    collectives never stall its host)."""

    num_replicas: int
    process_index: int = 0
    process_count: int = 1
    distributed: bool = False
    host_group: Any = None
    blocked_s: float = 0.0

    @property
    def local_replica_count(self) -> int:
        return self.num_replicas // self.process_count

    @property
    def first_replica(self) -> int:
        """Global index of this process's first replica."""
        return self.process_index * self.local_replica_count

    @property
    def measured_timing_supported(self) -> bool:
        """Each replica lives wholly on one process, so one process's
        measured time can fill its rows (≙ the reference's property;
        :func:`make_topology` refuses a topology without it)."""
        return (self.num_replicas % self.process_count == 0
                and self.num_replicas >= self.process_count)

    def split_batch(self, x: torch.Tensor) -> torch.Tensor:
        """This process's batch ``[B/P, ...]`` → ``[L, B/n, ...]``: local
        replica j takes rows ``[j·B/n, (j+1)·B/n)`` of it (with one
        process, replica r takes block r of the global batch, the
        reference's ``P(replica)`` block)."""
        L = self.local_replica_count
        if x.shape[0] % L:
            raise ValueError(f"process batch {x.shape[0]} not divisible by "
                             f"{L} local replicas")
        return x.view(L, -1, *x.shape[1:])

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` in place over the processes: through the gloo host
        group for a CPU tensor, the default group otherwise."""
        group = self.host_group if x.device.type == "cpu" else None
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        self.blocked_s += time.perf_counter() - t0
        return x

    def sum_replicas(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over all ``n`` replicas of a ``[L, ...]`` tensor of this
        process's replicas: the local sum (:func:`local_sum`), then one
        all-reduce (≙ the reference's ``lax.psum`` over the replica
        axis)."""
        out = local_sum(x)
        return self._all_reduce(out) if self.distributed else out

    def gather_scalars(self, x: torch.Tensor) -> torch.Tensor:
        """``[L, ...]`` rows of this process's replicas → ``[n, ...]`` in
        replica order on every process: a zeros ``[n, ...]`` with this
        process's rows written in, one all-reduce (≙
        ``_gather_replicated``'s one-hot psum: every other row adds an
        exact zero, so the result is bitwise the rows)."""
        if not self.distributed:
            return x
        out = x.new_zeros((self.num_replicas, *x.shape[1:]))
        first = self.first_replica
        out[first:first + self.local_replica_count] = x
        return self._all_reduce(out)

    def reduce_scatter_replicas(self, x: torch.Tensor) -> torch.Tensor:
        """``[L, n, C]`` (each local replica's row for every replica) →
        ``[L, C]``: row ``j`` summed over all ``n`` replicas' ``first + j``
        rows. The local sum over the ``L`` replicas (:func:`local_sum`,
        the order of :meth:`sum_replicas`), then, with a process group,
        one ``reduce_scatter`` hands process ``p`` rows ``[p·L,
        (p+1)·L)``."""
        out = local_sum(x)
        if not self.distributed:
            return out
        mine = out.new_empty((self.local_replica_count, out.shape[1]))
        t0 = time.perf_counter()
        _reduce_scatter(mine, out)
        self.blocked_s += time.perf_counter() - t0
        return mine

    def all_gather_replicas(self, x: torch.Tensor) -> torch.Tensor:
        """``[L, C]`` rows of this process's replicas → ``[n, C]`` in
        replica order on every process (one ``all_gather``; ``x`` as is
        with one process)."""
        if not self.distributed:
            return x
        out = x.new_empty((self.num_replicas, x.shape[1]))
        t0 = time.perf_counter()
        _all_gather(out, x.contiguous())
        self.blocked_s += time.perf_counter() - t0
        return out

    def sum_processes(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the processes (one all-reduce; ``x`` as is
        with one process)."""
        return self._all_reduce(x) if self.distributed else x


# the single-tensor collectives under their current names (older torch
# spells them reduce_scatter_tensor / all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor")
_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


def make_topology(cfg: MeshConfig) -> Topology:
    """``mesh.num_replicas`` replicas, or ``mesh.simulate_devices`` when
    ``num_replicas`` is -1 (the reference's "every device" on its forced
    CPU mesh), else one; over the processes of the group
    :func:`initialize_distributed` made, if any. Model, sequence,
    pipeline and expert parallelism are not ported."""
    for name in ("model_parallelism", "seq_parallelism",
                 "pipeline_parallelism", "expert_parallelism"):
        if getattr(cfg, name) != 1:
            raise NotImplementedError(f"mesh.{name} > 1 is not ported yet")
    n = cfg.num_replicas
    if n == -1:
        n = cfg.simulate_devices if cfg.simulate_devices > 0 else 1
    if n < 1:
        raise ValueError(f"mesh.num_replicas must be -1 or >= 1, got {n}")
    if not dist.is_initialized():
        return Topology(num_replicas=n)
    topo = Topology(num_replicas=n, process_index=dist.get_rank(),
                    process_count=dist.get_world_size(), distributed=True,
                    host_group=_host_group)
    if not topo.measured_timing_supported:
        raise ValueError(f"{n} replicas do not split evenly over "
                         f"{topo.process_count} processes: set "
                         "mesh.num_replicas to a multiple of the process "
                         "count")
    return topo


def _device_identity(dev: torch.device) -> str:
    """The physical card behind ``dev`` on this host."""
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    card = (str(uuid) if uuid is not None else
            f"{os.environ.get('CUDA_VISIBLE_DEVICES', '')}#{dev.index}")
    return f"{socket.gethostname()}/{card}"


def _refuse_shared_cards(store, rank: int, world: int,
                         dev: torch.device) -> None:
    """Every rank publishes its card through the rendezvous store and
    reads the others': two NCCL ranks on one card raise here, on each
    rank, before the group is made (NCCL itself would abort with
    "Duplicate GPU detected")."""
    store.set(f"dmt_card/{rank}", _device_identity(dev))
    cards = [store.get(f"dmt_card/{r}").decode() for r in range(world)]
    read = store.add("dmt_card/read", 1)
    mine = [r for r, c in enumerate(cards) if c == cards[rank]]
    if len(mine) > 1:
        # rank 0 holds the store: it leaves only once every rank has read
        while rank == 0 and read < world:
            time.sleep(0.01)
            read = store.add("dmt_card/read", 0)
        raise RuntimeError(
            f"ranks {mine} all want {dev} ({cards[rank]}) for NCCL, which "
            "takes one card per rank: give each rank its own card, or run "
            "them on one card with --dist-backend gloo")


def initialize_distributed(backend: str | None = None,
                           device: str | torch.device | None = None,
                           timeout_s: float = 300.0) -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``).

    ``backend`` is ``nccl`` or ``gloo`` (default: ``nccl`` when the
    device — ``device``, else ``cuda:$LOCAL_RANK`` — is a card, ``gloo``
    on the CPU); nothing falls back to another backend. A collective
    that waits longer than ``timeout_s`` fails instead of hanging. With
    NCCL a gloo side group is made for host tensors. Returns False, and
    does nothing, when ``WORLD_SIZE`` is unset; True when a group is up
    (already, or now). Call it before the Trainer is built."""
    global _host_group
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}; "
                         "use --dist-backend gloo on the CPU")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    timeout = datetime.timedelta(seconds=timeout_s)
    store, rank, world = next(dist.rendezvous("env://", rank, world,
                                              timeout=timeout))
    store.set_timeout(timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, rank, world, dev)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            rank=rank, world_size=world, timeout=timeout)
    _host_group = (dist.new_group(backend="gloo", timeout=timeout)
                   if backend == "nccl" else None)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if one is up."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
