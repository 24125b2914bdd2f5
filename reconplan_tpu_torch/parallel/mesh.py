"""Device meshes and placements over torch devices and ``torch.distributed``.

Port of ``reconplan_tpu.parallel.mesh``. A :class:`Mesh` is the shards of
one axis: this process's devices in order (repeats allowed: several
shards on one card run in turn), the axis's name, and the process group
whose other ranks hold the other shards, or ``None`` when this process
holds them all. Every rank holds the same number of shards, and shard
``s`` of the mesh is local shard ``s - rank * len(devices)`` of rank
``s // len(devices)``.

A :class:`Placement` (from :func:`shard_grid`, :func:`shard_batch` or
:func:`replicate`) stands for a ``NamedSharding``, and its ``put`` for
``jax.device_put``. :func:`all_gather` and :func:`all_sum` are the two
collectives the sharded modules use: the identity without a group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from reconplan_tpu_torch.utils.device import resolve_device


class Mesh(NamedTuple):
    """A 1-D mesh: this process's shard devices, the axis name and the
    process group (``None``: one process). A mesh, and every sharded
    grid that carries one, holds its group: drop them before
    ``dist.destroy_process_group()``, or the group is torn down at
    interpreter exit, where gloo's teardown can abort the process."""

    devices: tuple
    axis_name: str = "space"
    group: object = None

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """The mesh's shard count over every rank."""
        return len(self.devices) * self.world_size

    @property
    def first_shard(self) -> int:
        """The mesh index of this process's first shard."""
        return self.rank * len(self.devices)


def _indexed(device) -> torch.device:
    """``device`` resolved, a card with its index (the current card when
    none is named), as the tensors on it report it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices=None, axis_name="space", devices=None) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible card, or this
    rank's card, ``torch.cuda.current_device()``, when a process group is
    initialised; without a card that default raises).

    Without a group, ``n_devices`` keeps the first ``n_devices`` of them,
    as the JAX function keeps the first of ``jax.devices()``; under a
    group it is the mesh's size over every rank and must be that.
    ``["cpu"] * n`` asks for ``n`` shards on the CPU.
    """
    group = dist.group.WORLD if (dist.is_available()
                                 and dist.is_initialized()) else None
    if devices is None:
        resolve_device(None)
        devices = ([torch.cuda.current_device()] if group is not None
                   else range(torch.cuda.device_count()))
        devices = [torch.device("cuda", i) for i in devices]
    devices = tuple(_indexed(d) for d in devices)
    mesh = Mesh(devices, axis_name, group)
    if n_devices is not None:
        if group is None:
            mesh = mesh._replace(devices=devices[:n_devices])
        elif n_devices != mesh.size:
            raise ValueError(f"a mesh of {n_devices} devices asked for over "
                             f"{mesh.world_size} ranks of {len(devices)}")
    if not mesh.devices:
        raise ValueError("a mesh needs at least one device")
    return mesh


class Placement(NamedTuple):
    """Where a tensor's pieces go: ``spec`` as a JAX ``PartitionSpec``,
    the mesh's axis name on a split dimension (only axis 0 splits here)
    and ``None`` on the others; ``()`` replicates."""

    mesh: Mesh
    spec: tuple

    def put(self, x) -> tuple:
        """``x`` on this process's shards, one tensor a local shard: the
        rows of axis 0 that the shard owns, or a copy of the whole on
        each distinct device (shards on one device share it). Raises
        when axis 0 does not divide by the mesh size."""
        x = torch.as_tensor(x)
        if len(self.spec) > x.ndim:
            raise ValueError(f"a spec of {len(self.spec)} axes for a tensor "
                             f"of {x.ndim}")
        devices = self.mesh.devices
        if not self.spec:
            copies = {}
            for d in devices:
                if d not in copies:
                    copies[d] = x.to(d)
            return tuple(copies[d] for d in devices)
        n = self.mesh.size
        if x.shape[0] % n:
            raise ValueError(f"dimension 0 of {tuple(x.shape)} is not "
                             f"divisible by the mesh size {n}")
        m, s0 = x.shape[0] // n, self.mesh.first_shard
        return tuple(x[(s0 + i) * m:(s0 + i + 1) * m].to(d, copy=True)
                     for i, d in enumerate(devices))


def check_mesh(grid, mesh):
    """Raise if ``mesh`` is given and is not the mesh the sharded ``grid``
    was made on (the grid carries it; a call may name it again)."""
    if mesh is not None and mesh != grid.mesh:
        raise ValueError(f"mesh {mesh} is not the grid's {grid.mesh}")


def _placement(mesh, spec) -> Placement:
    if any(a is not None and a != mesh.axis_name for a in spec):
        raise ValueError(f"axis {spec[0]!r} is not the mesh's "
                         f"{mesh.axis_name!r}")
    return Placement(mesh, spec)


def shard_grid(mesh, axis_name="space") -> Placement:
    """Placement that splits a (D, H, W) volume along z (axis 0)."""
    return _placement(mesh, (axis_name, None, None))


def shard_batch(mesh, axis_name="space") -> Placement:
    """Placement that splits a batch along axis 0."""
    return _placement(mesh, (axis_name,))


def replicate(mesh) -> Placement:
    return Placement(mesh, ())


def all_gather(mesh, block) -> torch.Tensor:
    """The blocks of every rank concatenated along axis 0 in mesh order,
    ``block`` being this rank's (its shards' rows, in order); ``block``
    itself without a group. Every rank gets the whole."""
    if mesh.group is None:
        return block
    block = block.contiguous()
    parts = [torch.empty_like(block) for _ in range(mesh.world_size)]
    dist.all_gather(parts, block, group=mesh.group)
    return torch.cat(parts)


def all_sum(mesh, x) -> torch.Tensor:
    """``x`` summed over the ranks; ``x`` itself without a group."""
    if mesh.group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=mesh.group)
    return x
