"""Collectives over a mesh axis: the port's counterparts of the
``jax.lax`` collectives that the reference calls inside ``shard_map``.

One process is one shard (parallel/mesh.py). An axis is named as in the
reference (``"dp"``, ``"sp"``) and resolves through the innermost mesh
entered with ``with mesh:``; each call is one ``torch.distributed`` call
on that axis's process group, so every shard of the axis must make the
same calls in the same order, as the SPMD program of a ``shard_map`` does.

- ``axis_index(axis)`` and ``axis_size(axis)``;
- ``all_gather(x, axis, tiled=True)``: every shard's ``x`` in shard order,
  concatenated on the leading axis (``tiled``) or stacked;
- ``pmax(x, axis)`` and ``psum(x, axis)``: elementwise over the shards (the
  max is exact; a sum's add order is the backend's, so the port uses it
  only where the reference does);
- ``ppermute(x, axis, perm)``: ``(source, destination)`` pairs of shard
  indices, each shard receiving from at most one;
- ``barrier(axis)``: returns once every shard of the axis has called it.

On an axis of one shard every call is the identity, with no process group.
A gloo group moves CPU tensors: where an op does not take CUDA tensors
(``GLOO_CUDA_OPS``), the tensor is copied to the host and back, and the
copies are counted. Every call adds the bytes this shard receives to its
op's count (``counts``, ``reset_counts``), and the count of host copies to
``host_copies``. A failed collective raises; nothing retries it or falls
back to another backend.
"""

import torch
import torch.distributed as dist

#: the gloo ops that take CUDA tensors as they are
#: (modppl_tpu_torch/probes/gloo_cuda.py on an H100, torch 2.11: gloo's
#: send and recv fail on a CUDA tensor, "writev ... Bad address"); every
#: other gloo op on a CUDA tensor stages through the host
GLOO_CUDA_OPS = frozenset({"all_gather", "pmax", "psum"})

_COUNTS = {}
_HOST_COPIES = [0]


def reset_counts():
    """Set every op's call and byte counts and the host copies to 0."""
    _COUNTS.clear()
    _HOST_COPIES[0] = 0


def counts():
    """``{op: {"calls": c, "bytes": b, "max_bytes": m}}`` since the last
    reset (``m`` the most one call received), with ``"host_copies"``: the
    tensors staged through the host (each way)."""
    out = {op: dict(c) for op, c in _COUNTS.items()}
    out["host_copies"] = _HOST_COPIES[0]
    return out


def _count(op, nbytes):
    c = _COUNTS.setdefault(op, {"calls": 0, "bytes": 0, "max_bytes": 0})
    c["calls"] += 1
    c["bytes"] += int(nbytes)
    c["max_bytes"] = max(c["max_bytes"], int(nbytes))


def _axis(axis):
    from modppl_tpu_torch.parallel.mesh import current_mesh

    if not isinstance(axis, str):
        return axis
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(f"collective over axis {axis!r} outside a mesh: "
                           "enter the mesh first (`with mesh:`)")
    return mesh.axis(axis)


def axis_index(axis):
    """This shard's index along ``axis``."""
    return _axis(axis).index


def axis_size(axis):
    """The number of shards along ``axis``."""
    return _axis(axis).size


def _staged(ax, op, x):
    """``x`` as the group's backend takes it for ``op``, and the function
    that brings a result back to ``x``'s device."""
    if x.is_cuda and ax.backend == "gloo" and op not in GLOO_CUDA_OPS:
        _HOST_COPIES[0] += 2
        device = x.device
        return x.cpu(), lambda y: y.to(device)
    return x, lambda y: y


def all_gather(x, axis, tiled=True):
    """The ``x`` of every shard along ``axis`` in shard order: concatenated
    on the leading axis with ``tiled`` (a 0-dim ``x`` as a 1-D one), else
    stacked on a new one."""
    ax = _axis(axis)
    x = x.contiguous()
    if ax.size == 1:
        return x.reshape((-1,) + tuple(x.shape[1:])) if tiled else x[None]
    src, back = _staged(ax, "all_gather", x)
    parts = [torch.empty_like(src) for _ in range(ax.size)]
    dist.all_gather(parts, src, group=ax.group)
    _count("all_gather", (ax.size - 1) * x.nbytes)
    if tiled:
        out = torch.cat([p.reshape((-1,) + tuple(p.shape[1:]))
                         for p in parts])
    else:
        out = torch.stack(parts)
    return back(out)


def _reduce(op_name, op, x, axis):
    ax = _axis(axis)
    if ax.size == 1:
        return x
    src, back = _staged(ax, op_name, x.contiguous())
    out = src.clone()
    dist.all_reduce(out, op=op, group=ax.group)
    _count(op_name, (ax.size - 1) * x.nbytes)
    return back(out)


def pmax(x, axis):
    """The elementwise maximum of ``x`` over the shards of ``axis``."""
    return _reduce("pmax", dist.ReduceOp.MAX, x, axis)


def psum(x, axis):
    """The elementwise sum of ``x`` over the shards of ``axis`` (in the
    backend's add order)."""
    return _reduce("psum", dist.ReduceOp.SUM, x, axis)


def ppermute(x, axis, perm):
    """``x`` sent along the ``(source, destination)`` pairs of ``perm``
    (shard indices of ``axis``): each shard returns what its source sent
    it, or zeros if none sends to it."""
    ax = _axis(axis)
    me = ax.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(src) > 1 or len(dst) > 1:
        raise ValueError(f"ppermute: shard {me} in more than one pair of "
                         f"{perm}")
    x = x.contiguous()
    if ax.size == 1 or (src == [me] and dst == [me]):
        return x.clone() if src else torch.zeros_like(x)
    send, back = _staged(ax, "ppermute", x)
    recv = torch.zeros_like(send)
    # one batch of the shard's send and receive: a ring of separate
    # blocking sends would wait on each other (NCCL)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send, ax.ranks[dst[0]],
                              group=ax.group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, ax.ranks[src[0]],
                              group=ax.group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if src:
        _count("ppermute", x.nbytes)
    return back(recv)


def barrier(axis):
    """Return once every shard of ``axis`` has called this."""
    ax = _axis(axis)
    if ax.size > 1:
        dist.barrier(group=ax.group)
