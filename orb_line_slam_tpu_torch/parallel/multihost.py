"""The shard mesh and the multi-process runtime of the distributed BA.

Port of ``orb_line_slam_tpu/parallel/multihost.py:26-70``.  JAX reduces
with ``jax.lax.psum`` over the axis of a ``jax.sharding.Mesh``; here a
``ShardMesh`` is an ordered list of shard slots, each with a
``torch.device``.  A process holds some of the slots (a contiguous run,
processes in rank order, as ``jax.devices()`` orders the devices of a
multi-process runtime), and a ``torch.distributed`` process group joins
the processes when there are several.  Several slots may share one
device: that is how one process stands for JAX's 8-device CPU mesh, and
how one card runs more than one shard.

``psum`` of a per-shard partial is: the process's own partials summed in
slot order on its first slot's device, then one ``all_reduce(SUM)``
across the processes of the group, if there is one.  Every rank gets the
same reduced bits, so a scalar that decides an accept branch takes the
same branch on every rank and the ranks issue the same collectives.

On real hardware the entry path is, as in the JAX package:

    from orb_line_slam_tpu_torch.parallel import multihost
    multihost.initialize(coordinator, num_processes, process_id)
    mesh = multihost.global_mesh()
    ba = make_distributed_ba_cg(mesh, cam, ...)
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

# The mesh that initialize() built: the process group is process-wide
# state, and so is the mesh over it.
_GLOBAL_MESH: ShardMesh | None = None


class ShardMesh:
    """Shard slots 0 .. n_shards - 1.  This process holds slots
    ``first .. first + len(devices) - 1``; ``group`` (None: one process)
    joins the processes.  ``n_reductions`` / ``reduced_bytes`` count the
    psums and the bytes each reduced (the size of one partial), and
    ``n_collectives`` the all_reduce calls that crossed processes."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard mesh needs at least one local shard")
        self.group = group
        counts = [len(self.devices)]
        if group is not None:
            # NCCL exchanges device tensors only; gloo takes host ones.
            where = self.home if dist.get_backend(group) == "nccl" else "cpu"
            n = torch.tensor([len(self.devices)], dtype=torch.int64, device=where)
            counts_t = [torch.zeros_like(n) for _ in range(dist.get_world_size(group))]
            dist.all_gather(counts_t, n, group=group)
            counts = [int(c.item()) for c in counts_t]
            self.rank = dist.get_rank(group)
        else:
            self.rank = 0
        self.n_shards = sum(counts)
        self.first = sum(counts[: self.rank])
        self.n_reductions = 0
        self.reduced_bytes = 0
        self.n_collectives = 0

    @property
    def home(self) -> torch.device:
        """The first local slot's device: replicated values live here."""
        return self.devices[0]

    @property
    def n_local(self) -> int:
        return len(self.devices)

    def reset_counts(self):
        self.n_reductions = self.reduced_bytes = self.n_collectives = 0

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum over every shard of the mesh of one partial per local
        shard (``parts[i]`` of slot ``first + i``), on the home device."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        self.n_reductions += 1
        self.reduced_bytes += total.numel() * total.element_size()
        if self.group is not None:
            if len(parts) == 1:
                total = total.clone()          # all_reduce writes in place
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
            self.n_collectives += 1
        return total


def device_mesh(device, n_shards: int) -> ShardMesh:
    """A one-process mesh of n_shards slots on one device: several shards
    on one card, or, on "cpu", the port's counterpart of
    ``--xla_force_host_platform_device_count`` in the tests."""
    return ShardMesh([torch.device(device)] * n_shards)


def _local_devices(device_type: str) -> list[torch.device]:
    """One shard per visible device of device_type: every CUDA device (no
    card raises), or one CPU shard when "cpu" is asked for."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("a CUDA shard mesh was asked for, but torch sees no CUDA device; pass "
                               "device_type='cpu' (or CPU local_shards) for a CPU mesh")
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device(device_type)]


def initialize(coordinator: str, num_processes: int, process_id: int, local_shards=None, backend=None,
               timeout_s: float = 120.0) -> ShardMesh:
    """Join (or start, for process 0) a group of num_processes processes
    at ``coordinator`` ("host:port"), and build the global mesh over it.

    local_shards: None (every visible CUDA device, one shard each; no
    card raises), an int (that many CPU shards: the CPU testing path, as
    the JAX package's local_device_count), or a list of devices.  The backend is NCCL for CUDA shards and gloo for
    CPU ones unless named.  A group that does not form within timeout_s
    raises; nothing carries on as a single process."""
    global _GLOBAL_MESH
    if isinstance(local_shards, int):
        devices = [torch.device("cpu")] * local_shards
    elif local_shards is None:
        devices = _local_devices("cuda")
    else:
        devices = [torch.device(d) for d in local_shards]
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("CUDA shards were asked for, but torch sees no CUDA device")
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    devices = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
               for d in devices]
    if devices[0].type == "cuda":
        torch.cuda.set_device(devices[0])
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=timeout)
    if dist.get_world_size() != num_processes:
        raise RuntimeError(f"joined a group of {dist.get_world_size()} processes, asked for {num_processes}")
    _GLOBAL_MESH = ShardMesh(devices, group=dist.group.WORLD)
    return _GLOBAL_MESH


def shutdown():
    """Leave the process group that initialize() joined."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = None
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(device_type: str = "cuda") -> ShardMesh:
    """The counterpart of ``Mesh(np.array(jax.devices()))``: the mesh that
    initialize() built over device_type, or, in a process that joined no
    group, one shard per visible CUDA device (no card raises), or one CPU
    shard for device_type "cpu"."""
    if _GLOBAL_MESH is not None and _GLOBAL_MESH.home.type == device_type:
        return _GLOBAL_MESH
    return ShardMesh(_local_devices(device_type))


def make_global_array(mesh: ShardMesh, x) -> list[torch.Tensor]:
    """This process's slots' slices of an array sharded on its first axis,
    from a host copy that is identical in every process: slot s holds rows
    ``s * n / n_shards .. (s + 1) * n / n_shards - 1``, on the slot's
    device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    n = x.shape[0]
    if n % mesh.n_shards:
        raise ValueError(f"axis of {n} rows does not split over {mesh.n_shards} shards")
    per = n // mesh.n_shards
    return [x[(mesh.first + i) * per:(mesh.first + i + 1) * per].to(d)
            for i, d in enumerate(mesh.devices)]
