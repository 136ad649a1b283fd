"""Checkpoint / resume for long inference runs (counterpart of
modppl_tpu/utils/checkpoint.py).

A state (a particle system, chain positions, a whole Trace) is saved as
``<path>.npz``, one array a leaf named ``f"{i:05d}|{path}"``, and
``<path>.json`` with the step and the caller's metadata: the reference's
layout, so a plain dict of arrays written by either package restores in
the other. It is restored into an example of the same structure, each leaf
onto the example leaf's device.

The port's states are not JAX pytrees, so this module flattens them
itself, with paths: tensors, numpy arrays and Python numbers are leaves;
dicts (in sorted key order, as JAX lays them out), tuples, lists and
dataclasses are nodes; a ``Trie`` flattens as the
reference's does (its value and log-probability, then its children in
sorted order) and a ``Trace`` as (args, data, retv, logjp); None is an
empty node. A host key, a Python int up to 2^64 (core/keys.py), is saved
as uint64 when it does not fit in int64, and restores to the same int.
"""

import dataclasses
import json
import os

import numpy as np
import torch

from modppl_tpu_torch.core.gfi import Trace
from modppl_tpu_torch.core.trie import Trie

_INT64_MAX = (1 << 63) - 1


def _is_leaf(x):
    return (torch.is_tensor(x) or isinstance(x, (np.ndarray, np.generic))
            or isinstance(x, (bool, int, float)))


def tree_flatten_with_path(tree):
    """``(leaves, rebuild)``: ``leaves`` the ``(path, leaf)`` pairs in
    order, ``rebuild(new_leaves)`` the same structure around new leaves."""
    out = []

    def walk(x, path):
        if x is None:
            return lambda it: None
        if _is_leaf(x):
            out.append(("/".join(path), x))
            return lambda it: next(it)
        if isinstance(x, Trie):
            parts = ([x.value] if x.has_inner() else []) + [x.logp] + [
                x.children[k] for k in sorted(x.children)]
            builds = [walk(p, path + [str(i)]) for i, p in enumerate(parts)]

            def trie(it, x=x, builds=builds):
                vals = [b(it) for b in builds]
                t = x.copy()
                if x.has_inner():
                    t.value = vals.pop(0)
                t.logp = vals.pop(0)
                t.children = dict(zip(sorted(x.children), vals))
                return t
            return trie
        if isinstance(x, Trace):
            builds = [walk(p, path + [str(i)]) for i, p in
                      enumerate((x.args, x.data, x.retv, x.logjp))]
            return lambda it: Trace(*(b(it) for b in builds))
        if isinstance(x, dict):
            keys = sorted(x)
            builds = [walk(x[k], path + [str(k)]) for k in keys]
            return lambda it: dict(zip(keys, (b(it) for b in builds)))
        if type(x) in (tuple, list):
            builds = [walk(v, path + [str(i)]) for i, v in enumerate(x)]
            return lambda it: type(x)(b(it) for b in builds)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = [f.name for f in dataclasses.fields(x)]
            builds = [walk(getattr(x, f), path + [f]) for f in names]
            return lambda it: dataclasses.replace(
                x, **dict(zip(names, (b(it) for b in builds))))
        raise TypeError(f"checkpoint: cannot flatten {type(x).__name__} at "
                        f"'{'/'.join(path)}'")

    build = walk(tree, [])
    return out, lambda leaves: build(iter(leaves))


def _to_numpy(leaf):
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.bool_)
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.uint64 if leaf > _INT64_MAX
                          else np.int64)
    return np.asarray(leaf)


def _write_replace(target, write):
    """``write(f)`` into a temporary file beside ``target``, then rename it
    onto ``target``: a process killed mid-write leaves ``target`` whole."""
    tmp = target + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
    os.replace(tmp, target)


def save_checkpoint(path, state, step=None, key=None, metadata=None):
    """Save ``state`` to ``<path>.npz`` (+ ``<path>.json``: the metadata,
    ``step`` and ``key``; a host key as its int). Each file is written
    aside and renamed into place, the npz first: a kill between the two
    renames leaves a new npz beside the old step, which the drivers'
    restores detect by the step their carry records."""
    leaves, _ = tree_flatten_with_path(state)
    arrays = {f"{i:05d}|{p}": _to_numpy(leaf)
              for i, (p, leaf) in enumerate(leaves)}
    meta = dict(metadata or {})
    if step is not None:
        meta["step"] = int(step)
    if key is not None:
        meta["prng_key"] = (int(key) if isinstance(key, int)
                            else _to_numpy(key).tolist())
    _write_replace(path + ".npz", lambda f: np.savez(f, **arrays))
    _write_replace(path + ".json",
                   lambda f: f.write(json.dumps(meta).encode()))


def _restore_leaf(arr, example, where):
    """``arr`` as the example leaf's kind: a tensor on its device (same
    shape and dtype, or raise), a Python number, or an array."""
    if torch.is_tensor(example):
        got = torch.from_numpy(arr)
        if tuple(got.shape) != tuple(example.shape) or got.dtype != \
                example.dtype:
            raise ValueError(
                f"checkpoint leaf '{where}': saved {got.dtype} "
                f"{tuple(got.shape)}, the example holds {example.dtype} "
                f"{tuple(example.shape)}")
        return got.to(example.device)
    if isinstance(example, (bool, int, float)):
        if arr.shape != ():
            raise ValueError(f"checkpoint leaf '{where}': saved shape "
                             f"{arr.shape}, the example is a number")
        return type(example)(arr.item())
    return arr


def restore_checkpoint(path, example_state):
    """Restore a state saved by ``save_checkpoint`` into
    ``example_state``'s structure, each leaf onto the example leaf's device
    (a checkpoint of a card run restores to the card when the example is
    there). The leaf count and paths must match the example's, which is
    checked. Returns (state, metadata)."""
    leaves, rebuild = tree_flatten_with_path(example_state)
    with np.load(path + ".npz") as data:
        names = sorted(data.files)
        if len(names) != len(leaves):
            raise ValueError(
                f"checkpoint at {path} has {len(names)} leaves; example "
                f"structure has {len(leaves)}")
        restored = []
        for name, (p, leaf) in zip(names, leaves):
            saved = name.split("|", 1)[1]
            if saved != p:
                raise ValueError(f"checkpoint at {path}: leaf {name!r} where "
                                 f"the example has '{p}'")
            restored.append(_restore_leaf(data[name], leaf, p))
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return rebuild(restored), meta
