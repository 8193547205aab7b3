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

Tensor, sequence, pipeline and expert parallelism
(``mesh.model_parallelism = m``, ``mesh.seq_parallelism = s``,
``mesh.pipeline_parallelism = S``, ``mesh.expert_parallelism = e``; ≙
the reference's mesh, ``core/mesh.py:459-515``) spread each replica over
``m·s·S·e`` processes: the world is ``P_r × m × s × S × e`` processes
laid out in the reference's axis order ``(replica, model, seq, stage,
expert)``, so rank ``(((p·m + i)·s + j)·S + t)·e + k`` holds model
shard ``i``, sequence block ``j``, pipeline stage ``t`` and expert shard
``k`` of replica-process ``p``. The sub-groups are made once for each
layout and named by ``mesh.replica_axis`` / ``model_axis`` /
``seq_axis`` / ``stage_axis`` / ``expert_axis``: the replica group (the
``P_r`` processes with one ``(i, j, t, k)``) carries every
cross-replica sum above, the model group the Megatron all-reduces, the
seq group the ring, the all-to-alls and the gradient sums over sequence
blocks, the stage group the pipeline's point-to-point transfers
(:mod:`..ops.pipeline`) and the sums of the leaves every stage holds
whole, the expert group the mixture-of-experts all-to-alls, and the
expert×model group (the ``m·e`` processes with one ``(p, j, t)``) the
one sum that reassembles an expert layer's output. ``process_index`` /
``process_count`` are the replica-process coordinate ``p`` / ``P_r``
(the data shard a process reads: every process of one replica reads the
same rows); ``rank`` / ``world_size`` are the process group's.
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

from .config import ConfigError, MeshConfig
from .device import resolve_device

# the gloo group host tensors reduce over; None with a gloo default
# group (the default group is gloo already) or without a group
_host_group: Any = None
# the sub-groups of each (P_r, m, s, S, e) layout made so far: every
# rank makes every group of a layout once, in one order
# (dist.new_group's contract)
_layouts: dict[tuple[int, int, int, int, int], dict] = {}


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
class CommStats:
    """What one topology's collectives cost this process: the host
    seconds spent inside them, waiting for peers included, and the
    exchanges staged through host buffers (gloo and a CUDA tensor,
    :mod:`..ops.collectives`), and apart the all-reduces of CUDA tensors
    gloo copies through the host itself."""

    blocked_s: float = 0.0
    staged: dict = dataclasses.field(
        default_factory=lambda: {"ppermute": 0, "all_to_all": 0,
                                 "p2p": 0})
    staged_all_reduces: int = 0

    def timed(self, fn, *args, **kw):
        """``fn(*args, **kw)``, its host seconds added to ``blocked_s``."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.blocked_s += time.perf_counter() - t0
        return out


@dataclasses.dataclass
class Topology:
    """``num_replicas`` data-parallel replicas split evenly over
    ``process_count`` replica-processes; this one is ``process_index``
    and holds replicas ``[first_replica, first_replica +
    local_replica_count)`` on the device its state lives on — each of
    them, under tensor/sequence/expert parallelism, as model shard
    ``model_index`` of ``model_parallelism``, sequence block
    ``seq_index`` of ``seq_parallelism`` and expert shard
    ``expert_index`` of ``expert_parallelism``. ``distributed`` is set when a
    process group is up (even of one process): the sums then run
    through it. ``comm`` counts what this process's collectives cost —
    the sums here, and the tensor/sequence/expert collectives the
    step hands it to; :attr:`blocked_s` is their host seconds, waiting
    for peers included (the Trainer takes them out of its measured
    step time, as the reference's device-side collectives never stall
    its host).

    ``replica_group`` / ``model_group`` / ``seq_group`` /
    ``stage_group`` / ``expert_group`` are the sub-groups (None: the
    default group for the replica group; no group for a model, seq,
    stage or expert axis of 1); ``expert_model_group`` the expert×model
    ranks of one replica, sequence block and stage (the expert group
    without tensor parallelism, None without expert parallelism);
    ``replica_host_group`` the group host tensors sum over the replicas
    in (the replica group itself under gloo, its gloo twin under NCCL;
    None: the default group). ``axis_names`` are the config's
    ``(replica, model, seq, expert, stage)`` axis names (the stage last,
    so the others keep their indices)."""

    num_replicas: int
    process_index: int = 0
    process_count: int = 1
    distributed: bool = False
    host_group: Any = None
    comm: CommStats = dataclasses.field(default_factory=CommStats)
    model_parallelism: int = 1
    seq_parallelism: int = 1
    model_index: int = 0
    seq_index: int = 0
    expert_parallelism: int = 1
    expert_index: int = 0
    pipeline_parallelism: int = 1
    stage_index: int = 0
    rank: int = 0
    world_size: int = 1
    replica_group: Any = None
    replica_host_group: Any = None
    model_group: Any = None
    seq_group: Any = None
    stage_group: Any = None
    expert_group: Any = None
    expert_model_group: Any = None
    axis_names: tuple[str, ...] = ("replica", "model", "seq", "expert",
                                   "stage")

    @property
    def blocked_s(self) -> float:
        """Host seconds this process spent inside collectives."""
        return self.comm.blocked_s

    @property
    def span(self) -> int:
        """The processes one replica spans: ``m·s·S·e``."""
        return (self.model_parallelism * self.seq_parallelism
                * self.pipeline_parallelism * self.expert_parallelism)

    @property
    def sharded(self) -> bool:
        """Whether a replica spans several processes (``m·s·S·e > 1``)."""
        return self.span > 1

    @property
    def replica_leader(self) -> bool:
        """The process whose measured time fills its replicas' rows:
        model shard 0, sequence block 0, stage 0, expert shard 0 (≙ the
        reference's ``measured_timing_supported``: one owner a row)."""
        return (self.model_index == 0 and self.seq_index == 0
                and self.stage_index == 0 and self.expert_index == 0)

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

    def _all_reduce(self, x: torch.Tensor, world: bool = False,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``x`` in place over the replica-processes (``world``:
        over every process): through the gloo twin for a CPU tensor."""
        cpu = x.device.type == "cpu"
        if world:
            group = self.host_group if cpu else None
        else:
            group = self.replica_host_group if cpu else self.replica_group
        self.comm.timed(dist.all_reduce, x, op=op, group=group)
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
        replica order on every process: an ``[n, ...]`` of ``-inf`` with
        this process's rows written in, one max all-reduce over every
        process (≙ ``_gather_replicated``'s one-hot psum, where every
        other row adds an exact zero: the max is bitwise the rows as
        well). When a replica spans several processes (:attr:`sharded`)
        its ``m·s·S·e`` processes may each write its rows: a row holds the
        largest value written there (write ``-inf`` for no value)."""
        if not self.distributed:
            return x
        out = x.new_full((self.num_replicas, *x.shape[1:]), float("-inf"))
        first = self.first_replica
        out[first:first + self.local_replica_count] = x
        return self._all_reduce(out, world=True, op=dist.ReduceOp.MAX)

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
        self.comm.timed(_reduce_scatter, mine, out, group=self.replica_group)
        return mine

    def all_gather_replicas(self, x: torch.Tensor) -> torch.Tensor:
        """``[L, C]`` rows of this process's replicas → ``[n, C]`` in
        replica order on every process (one ``all_gather``; ``x`` as is
        with one process)."""
        if not self.distributed:
            return x
        out = x.new_empty((self.num_replicas, x.shape[1]))
        self.comm.timed(_all_gather, out, x.contiguous(),
                        group=self.replica_group)
        return out

    def sum_processes(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the replica-processes (one all-reduce; ``x``
        as is with one process)."""
        return self._all_reduce(x) if self.distributed else x

    def sum_seq(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed in place over the seq group (as it is without
        sequence parallelism)."""
        if self.seq_group is not None:
            self.comm.timed(dist.all_reduce, x, group=self.seq_group)
        return x

    def sum_group(self, x: torch.Tensor, group) -> torch.Tensor:
        """``x`` summed over ``group``, one of this topology's sub-groups
        (a new tensor)."""
        x = x.clone()
        self.comm.timed(dist.all_reduce, x, group=group)
        return x

    def all_gather(self, out: list, x: torch.Tensor, group) -> None:
        """Every rank of ``group``'s ``x`` into ``out``, in rank order."""
        self.comm.timed(dist.all_gather, out, x, group=group)

    def seq_block(self, x: torch.Tensor) -> torch.Tensor:
        """This process's block of a ``[b, S, ...]`` token batch: columns
        ``[j·S/s, (j+1)·S/s)`` for sequence block ``j`` (≙
        ``device_put_batch(seq_sharded=True)``, reference
        ``core/mesh.py:318-340``); ``x`` itself without SP."""
        s = self.seq_parallelism
        if s == 1:
            return x
        if x.shape[1] % s:
            raise ValueError(f"seq_len {x.shape[1]} not divisible by "
                             f"mesh.seq_parallelism={s}")
        w = x.shape[1] // s
        return x[:, self.seq_index * w:(self.seq_index + 1) * w]

    def seq_positions(self, s_local: int, device) -> torch.Tensor:
        """The global positions of this process's sequence block."""
        return self.seq_index * s_local + torch.arange(s_local,
                                                       device=device)


# the single-tensor collectives under their current names (older torch
# spells them reduce_scatter_tensor / all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor")
_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")


def _make_groups(p_r: int, m: int, s: int, S: int, e: int) -> dict:
    """Every sub-group of the ``(P_r, m, s, S, e)`` layout, made once
    (all ranks call ``new_group`` for every group, in one order) and
    kept for later topologies of the layout: this rank's replica, model,
    seq, stage, expert and expert×model groups, and with an NCCL default
    group a gloo twin of its replica group for host tensors."""
    key = (p_r, m, s, S, e)
    if key in _layouts:
        return _layouts[key]
    rank_of = lambda p, i, j, t, k: (  # noqa: E731
        (((p * m + i) * s + j) * S + t) * e + k)
    me = dist.get_rank()
    gloo_twin = dist.get_backend() != "gloo"
    mine: dict = {}
    coords = [(p, i, j, t, k) for p in range(p_r) for i in range(m)
              for j in range(s) for t in range(S) for k in range(e)]

    def make(name, free):
        """One group a value of the coordinates not in ``free``, its
        ranks those that differ only in ``free``'s coordinates."""
        groups: dict = {}
        for c in coords:
            key = tuple(v for n, v in enumerate(c) if n not in free)
            groups.setdefault(key, []).append(rank_of(*c))
        for ranks in groups.values():
            g = dist.new_group(ranks)
            h = (dist.new_group(ranks, backend="gloo")
                 if name == "replica" and gloo_twin else g)
            if me in ranks:
                mine[name], mine[name + "_host"] = g, h

    make("replica", (0,))
    for name, size, free in (("model", m, (1,)), ("seq", s, (2,)),
                             ("stage", S, (3,)), ("expert", e, (4,))):
        if size > 1:
            make(name, free)
    if e > 1:
        if m > 1:
            make("expert_model", (1, 4))
        else:
            mine["expert_model"] = mine["expert"]
    _layouts[key] = mine
    return mine


def make_topology(cfg: MeshConfig) -> Topology:
    """``mesh.num_replicas`` replicas, or when ``num_replicas`` is -1
    (the reference's "every device") ``mesh.simulate_devices /
    (m·s·S·e)``, else one a replica-process; over the processes of the
    group :func:`initialize_distributed` made, if any.
    ``mesh.model_parallelism = m``, ``mesh.seq_parallelism = s``,
    ``mesh.pipeline_parallelism = S`` and ``mesh.expert_parallelism =
    e`` spread each replica over ``m·s·S·e`` processes (the layout in
    the module docstring), which needs a process group of
    ``P_r·m·s·S·e`` processes: without one this is a ConfigError, never
    a one-process run. ``mesh.pipeline_chunks > 1`` needs the ``1f1b``
    schedule (the reference's check)."""
    if cfg.pipeline_chunks > 1 and cfg.pipeline_schedule != "1f1b":
        # chunks only exist under the interleaved schedule — silently
        # ignoring them would hand back plain GPipe with its full
        # bubble while the config promises interleaving
        raise ValueError(
            f"mesh.pipeline_chunks={cfg.pipeline_chunks} requires "
            f"pipeline_schedule='1f1b' (got {cfg.pipeline_schedule!r})")
    m, s = int(cfg.model_parallelism), int(cfg.seq_parallelism)
    S, e = int(cfg.pipeline_parallelism), int(cfg.expert_parallelism)
    if m < 1 or s < 1 or S < 1 or e < 1:
        raise ConfigError(f"mesh.model_parallelism={m}, "
                          f"mesh.seq_parallelism={s}, "
                          f"mesh.pipeline_parallelism={S} and "
                          f"mesh.expert_parallelism={e} must be >= 1")
    span = m * s * S * e
    world = dist.get_world_size() if dist.is_initialized() else 1
    if span > 1 and (world < span or world % span):
        raise ConfigError(
            f"mesh.model_parallelism={m} × mesh.seq_parallelism={s} × "
            f"mesh.pipeline_parallelism={S} × mesh.expert_parallelism={e} "
            f"spread each replica over {span} processes, but this process "
            f"group has {world}: launch a multiple of {span} processes "
            f"under torchrun (e.g. torchrun --nproc_per_node {span} -m "
            "distributedmnist_tpu_torch.launch train ...)")
    p_r = world // span
    n = cfg.num_replicas
    if n == -1:
        n = (cfg.simulate_devices // span if cfg.simulate_devices > 0
             else (p_r if span > 1 else 1))
    if n < 1:
        raise ValueError(f"mesh.num_replicas must be -1 or >= 1, got {n}")
    names = (cfg.replica_axis, cfg.model_axis, cfg.seq_axis,
             cfg.expert_axis, cfg.stage_axis)
    if not dist.is_initialized():
        return Topology(num_replicas=n, axis_names=names)
    rank = dist.get_rank()
    topo = Topology(num_replicas=n, process_index=rank // span,
                    process_count=p_r, distributed=True,
                    host_group=_host_group, model_parallelism=m,
                    seq_parallelism=s, expert_parallelism=e,
                    pipeline_parallelism=S,
                    model_index=(rank // (s * S * e)) % m,
                    seq_index=(rank // (S * e)) % s,
                    stage_index=(rank // e) % S, expert_index=rank % e,
                    rank=rank, world_size=world,
                    replica_host_group=_host_group, axis_names=names)
    if not topo.measured_timing_supported:
        raise ValueError(f"{n} replicas do not split evenly over "
                         f"{p_r} replica-processes: set mesh.num_replicas "
                         "to a multiple of the process count"
                         + (f" / {span}" if span > 1 else ""))
    if span > 1:
        groups = _make_groups(p_r, m, s, S, e)
        topo.replica_group = groups["replica"]
        topo.replica_host_group = groups["replica_host"]
        topo.model_group = groups.get("model")
        topo.seq_group = groups.get("seq")
        topo.stage_group = groups.get("stage")
        topo.expert_group = groups.get("expert")
        topo.expert_model_group = groups.get("expert_model")
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
    _layouts.clear()


def serving_backend(device: torch.device, tp_ranks: int) -> str:
    """A tensor-parallel serving group's backend: NCCL when its ranks
    are on cards and the host has one for each rank, else gloo (ranks
    sharing a card, or the CPU). Not a fallback: the group runs on the
    one it is given, and fails when that fails."""
    if device.type == "cuda" and torch.cuda.device_count() >= tp_ranks:
        return "nccl"
    return "gloo"


def serving_topology(tp_ranks: int) -> Topology:
    """The topology of a tensor-parallel serving group (≙ the reference
    serving replica's ``replica=1 × model=tp_ranks`` mesh,
    ``servesvc/server.py:131-144``): one replica over the ``tp_ranks``
    processes of the group :func:`initialize_distributed` joined, this
    process holding model shard ``rank``; its model group is the whole
    group. Without such a group this is a ConfigError: the group's
    supervisor (``launch serve --tp-ranks``) starts its ranks with
    their rendezvous."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp_ranks:
        raise ConfigError(
            f"serve.tp_ranks={tp_ranks} serves over a group of {tp_ranks} "
            f"processes, but this process is in a group of {world}: start "
            "the group with `launch serve --tp-ranks N`, whose supervisor "
            "starts each rank with its rendezvous")
    return make_topology(MeshConfig(num_replicas=1,
                                    model_parallelism=tp_ranks))
