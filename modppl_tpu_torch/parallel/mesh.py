"""Meshes of processes (counterpart of modppl_tpu/parallel/mesh.py).

One process is one shard. A mesh is a ``(dp, sp)`` layout of the ranks of
a ``torch.distributed`` process group: ``"dp"`` is the particle / chain
axis (particles in SMC, chains in MCMC shard there), ``"sp"`` the data
axis. Each axis of more than one shard has a process group a row of the
layout, and the collectives of ``parallel/collectives.py`` run on it. A
process's shard index along an axis is its place in that row, so a mesh
over the whole world with ``sp = 1`` indexes ``dp`` by rank.

Tensors are local: a rank holds its own slice of the leading (particle or
chain) axis, and ``Mesh.gather`` assembles the whole in shard order. The
shardings (``particle_sharding``, ``data_sharding``, ``replicated``) say
which slice of a global leading axis a rank holds.

The backend is the caller's choice in ``initialize_runtime``: ``gloo`` on
the CPU and for ranks that share one card (NCCL refuses two ranks on one
GPU), ``nccl`` where each rank owns its card. Nothing swaps one for the
other.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "sp")
_ACTIVE = []


def initialize_runtime(coordinator_address=None, num_processes=None,
                       process_id=None, *, backend=None, timeout=300.0):
    """Bring up the ``torch.distributed`` process group (idempotent).

    ``coordinator_address`` is the rendezvous: ``"tcp://host:port"`` or
    ``"file:///path"`` (a ``FileStore``, which needs no port);
    ``num_processes`` the world size and ``process_id`` this rank.
    ``backend`` ("gloo" or "nccl") must be named. ``timeout`` (seconds)
    bounds every collective: a shard that never arrives makes the others
    raise rather than wait. With no coordinator and no process count this
    is a one-process run and nothing is brought up, as the reference's
    wrapper proceeds locally. A second call with the same backend is a
    no-op; with another it raises. With ``nccl`` the rank's current card
    becomes ``process_id % device_count`` first (a card a rank). Returns
    True when a group is up."""
    if dist.is_initialized():
        if backend is not None and backend != dist.get_backend():
            raise ValueError(f"initialize_runtime: the group is up with "
                             f"{dist.get_backend()!r}, not {backend!r}")
        return True
    if coordinator_address is None and num_processes is None:
        return False
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"initialize_runtime: backend must be 'gloo' or "
                         f"'nccl', got {backend!r}")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize_runtime: a distributed run needs "
                         "coordinator_address, num_processes and process_id")
    if backend == "nccl":
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=coordinator_address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout))
    return True


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def shard_device(device=None):
    """The device of this rank's shard: ``"cuda"`` (the default) is card
    ``rank % device_count``, so ranks share cards round-robin; any other
    device as named. Raises without a card unless told ``device="cpu"``."""
    from modppl_tpu_torch.modeling.handlers import entry_device

    device = entry_device(device, "mesh shard")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _world()[1] % torch.cuda.device_count())
    return device


class _Axis:
    """One mesh axis as this rank sees it: its size, this rank's index,
    the global ranks of its row in order, the row's process group and its
    backend."""

    __slots__ = ("name", "size", "index", "ranks", "group", "backend")

    def __init__(self, name, ranks, index, group):
        self.name = name
        self.ranks = [int(r) for r in ranks]
        self.size = len(self.ranks)
        self.index = index
        self.group = group
        self.backend = (dist.get_backend(group) if dist.is_initialized()
                        else None)


class Mesh:
    """A (dp, sp) layout of ranks. ``devices`` holds the ranks (the
    reference's ``Mesh.devices``), ``shape`` the axis sizes. ``with mesh:``
    makes the mesh the one the collectives resolve axis names through."""

    def __init__(self, ranks, groups):
        self.devices = ranks
        self.axis_names = AXES
        self.shape = dict(zip(AXES, ranks.shape))
        self.rank = _world()[1]
        where = np.argwhere(ranks == self.rank)
        self.coords = tuple(int(c) for c in where[0]) if len(where) else None
        self._axes = {}
        if self.coords is not None:
            i, j = self.coords
            self._axes["dp"] = _Axis("dp", ranks[:, j], i, groups.get(
                ("dp", j)))
            self._axes["sp"] = _Axis("sp", ranks[i, :], j, groups.get(
                ("sp", i)))

    @property
    def member(self):
        """True if this rank holds a shard of the mesh."""
        return self.coords is not None

    def axis(self, name):
        if name not in self._axes:
            raise ValueError(
                f"mesh axis {name!r}: this rank ({self.rank}) is not in the "
                f"mesh {self.devices.tolist()}" if self.coords is None
                else f"no mesh axis {name!r} (axes {AXES})")
        return self._axes[name]

    def gather(self, x, axis="dp"):
        """The whole of a tensor sharded on its leading axis over ``axis``,
        in shard order (one all_gather)."""
        from modppl_tpu_torch.parallel.collectives import all_gather

        return all_gather(x, self.axis(axis))

    def local(self, n, axis="dp"):
        """The slice of a leading axis of ``n`` that this rank holds."""
        ax = self.axis(axis)
        if n % ax.size:
            raise ValueError(f"a leading axis of {n} does not divide over "
                             f"{axis}={ax.size}")
        m = n // ax.size
        return slice(ax.index * m, (ax.index + 1) * m)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)

    def __repr__(self):
        return f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']})"


def current_mesh():
    """The innermost mesh entered with ``with mesh:``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def make_mesh(dp=None, sp=1, ranks=None):
    """A (dp, sp) mesh over ``ranks`` (default: every rank of the group,
    or this process alone without one), laid out row-major. dp * sp must
    equal the number of ranks. Every rank of the group must call this with
    the same arguments, in the same order as its other calls (a process
    group of a row is created on every rank); a rank outside ``ranks``
    gets a mesh it is not a ``member`` of."""
    world, _ = _world()
    ranks = np.arange(world) if ranks is None else np.asarray(ranks)
    n = ranks.size
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} != {n} ranks")
    if len(set(ranks.tolist())) != n or ranks.min() < 0 \
            or ranks.max() >= world:
        raise ValueError(f"mesh ranks {ranks.tolist()} are not distinct "
                         f"ranks of a world of {world}")
    layout = ranks.reshape(dp, sp)
    groups = {}
    rows = ([("dp", j, layout[:, j]) for j in range(sp)]
            + [("sp", i, layout[i, :]) for i in range(dp)])
    for name, k, row in rows:
        if len(row) < 2:
            continue
        if list(row) == list(range(world)):
            groups[(name, k)] = dist.group.WORLD
        else:
            # collective over the whole world, members or not
            groups[(name, k)] = dist.new_group([int(r) for r in row])
    return Mesh(layout, groups)


def global_mesh(dp=None, sp=1):
    """The (dp, sp) mesh over every rank of the group."""
    return make_mesh(dp=dp, sp=sp)


class Sharding:
    """Which slice of a global leading axis a rank holds: the shards of
    ``axis`` split it in order (None: every rank holds it whole)."""

    def __init__(self, mesh, axis):
        self.mesh = mesh
        self.axis = axis

    def local(self, x):
        """This rank's part of the global tensor ``x``."""
        if self.axis is None or getattr(x, "ndim", 0) == 0:
            return x
        return x[self.mesh.local(x.shape[0], self.axis)]

    def __repr__(self):
        return f"Sharding({self.mesh!r}, {self.axis!r})"


def particle_sharding(mesh):
    """Per-particle / per-chain tensors: the leading axis over dp."""
    return Sharding(mesh, "dp")


def data_sharding(mesh):
    """Plated data vectors: the leading axis over sp."""
    return Sharding(mesh, "sp")


def replicated(mesh):
    """Every rank holds the whole tensor."""
    return Sharding(mesh, None)


def constrain_particles(tree, mesh):
    """The identity on this rank's local tensors (they already hold its
    particles); checks that every leaf with a leading axis has the same
    length, the local particle count."""
    if mesh is None:
        return tree
    from torch.utils import _pytree as pytree

    sizes = {x.shape[0] for x in pytree.tree_leaves(tree)
             if torch.is_tensor(x) and x.ndim >= 1}
    if len(sizes) > 1:
        raise ValueError(f"constrain_particles: leading axes of lengths "
                         f"{sorted(sizes)} in one particle tree")
    return tree
