"""Effect handlers of the four GFI execution modes of the DSL (counterpart
of modppl_tpu/modeling/handlers.py).

``SimulateHandler``, ``GenerateHandler``, ``UpdateHandler`` and
``RegenerateHandler`` each provide ``sample(dist, params, addr)``,
``trace_call(gen_fn, args, addr)`` (alias ``trace``) and
``factor(logp, addr)``; update and regenerate also ``gc()``, the
visitor-complement garbage collection. The weight case matrix (constrained
x previous x ArgDiff) is the reference's, case for case.

Randomness comes from an explicit integer key (core/keys.py). Each address
derives its own key, ``fold_in(key, addr_hash(addr))``, and draws from a
``torch.Generator`` seeded with it on the handler's device, so sampling is
order-independent and reproducible. ``pool`` maps addresses to pre-drawn
values (or ``Standard`` draws) that replace a fresh draw; a call of
another generative function gets the entries below its address.

A key may also be a (C,) tensor of lane keys (core/keys.py), one a chain or
particle: the body then runs once over the lane axis, as on the batched
tier, each address's lane keys are ``fold_in_lanes(keys, addr_hash(addr))``
and a site draws one value a lane from its lane's own stream
(``Distribution.sample_lanes``). Lane i's draws are then those of the key
``keys[i]`` alone, whatever the other lanes; the weights are per lane.
"""

import torch

from modppl_tpu_torch.core.address import Selection, addr_hash, normalize_addr
from modppl_tpu_torch.core.gfi import ArgDiff, Trace
from modppl_tpu_torch.core.keys import fold_in, fold_in_lanes, generator
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.dists.base import Standard


def addr_subkey(key, addr):
    """The per-address key: ``fold_in(key, addr_hash(addr))``, lane by lane
    for a tensor of lane keys."""
    if torch.is_tensor(key):
        return fold_in_lanes(key, addr_hash(addr))
    return fold_in(key, addr_hash(addr))


def entry_device(device, what):
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names one. With no CUDA device the default raises; there is no CPU
    fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device='cuda' but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return device


def entry_inputs(device, args, observed, what):
    """An entry point's device (``entry_device``) with its model arguments
    (as a tuple) and observations moved there."""
    device = entry_device(device, what)
    return (device,
            to_device(args if isinstance(args, tuple) else (args,), device),
            to_device(observed, device))


def to_device(x, device, trie_tensors=False):
    """``x`` with every tensor in it (through tuples, lists, dicts and the
    values of Tries) on ``device``; anything else as it is. With
    ``trie_tensors``, every value of a Trie becomes a tensor on ``device``
    (a Python number a batched filter's constraint holds)."""
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, Trie):
        if trie_tensors:
            return x.map(lambda v: torch.as_tensor(v, device=device))
        return x.map(lambda v: to_device(v, device))
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device, trie_tensors) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, device, trie_tensors) for k, v in x.items()}
    return x


def infer_dtype_device(args, device=None):
    """dtype and device of the first floating tensor in ``args`` (searched
    through tuples, lists and traces: a proposal's argument); without one, torch's default dtype on the
    first tensor's device (an integer state, such as an HMM's). An explicit
    ``device`` wins over the arguments'. With neither a tensor nor a
    ``device``, raise: a model without tensor arguments must be told where
    to run rather than falling back to the CPU."""
    stack, first = list(args), None
    while stack:
        a = stack.pop(0)
        if torch.is_tensor(a) and a.is_floating_point():
            return a.dtype, torch.device(a.device if device is None
                                         else device)
        if torch.is_tensor(a) and first is None:
            first = a
        if isinstance(a, (tuple, list)):
            stack[:0] = list(a)
        elif isinstance(a, Trace):
            stack[:0] = [a.logjp, a.retv, a.args]
    if device is None and first is not None:
        device = first.device
    if device is None:
        raise ValueError(
            "no floating tensor argument to take a device from: pass "
            "device= (e.g. 'cuda' or 'cpu')")
    return torch.get_default_dtype(), torch.device(device)


def pooled(pool, dist, params, addr):
    """The pre-drawn value at ``addr`` (as written, else in its normal
    form, ``"coeffs / a"``), or None: a tensor is the value, a ``Standard``
    the sampler's standard draws at this site's params."""
    if pool is None:
        return None
    v = pool.get(addr)
    if v is None:
        v = pool.get(normalize_addr(addr))
    if v is None:
        return None
    return dist.from_standard(v.z, params) if isinstance(v, Standard) else v


def sub_pool(pool, addr):
    """The entries of ``pool`` below ``addr``, keyed from there (as the
    call at ``addr`` sees them), or None if there are none."""
    if not pool:
        return None
    prefix = normalize_addr(addr) + " / "
    sub = {k[len(prefix):]: v for k, v in
           ((normalize_addr(a), v) for a, v in pool.items())
           if k.startswith(prefix)}
    return sub or None


class _Handler:
    """State and primitives common to the four modes."""

    def __init__(self, key, trace, dtype, device, pool=None):
        self.key = key
        self.tr = trace
        self.dtype = dtype
        self.device = device
        self.pool = pool

    def _draw(self, dist, params, addr):
        """Fresh draw at an address, from its own stream (or the pool). The
        batched tier overrides this (modeling/autobatch.py)."""
        x = pooled(self.pool, dist, params, addr)
        if x is not None:
            return x
        if torch.is_tensor(self.key):
            return dist.sample_lanes(self._subkey(addr), params,
                                     dtype=self.dtype)
        g = generator(self._subkey(addr), self.device)
        return dist.sample(g, params, dtype=self.dtype)

    def _subkey(self, addr):
        """Key for a draw or a sub-generative-function call at ``addr``."""
        return addr_subkey(self.key, addr)

    def _sub(self, addr):
        """The key and keyword arguments of the call at ``addr``: its
        device and, if the pool holds draws below ``addr``, those."""
        kw = {"device": self.device}
        pool = sub_pool(self.pool, addr)
        if pool is not None:
            kw["pool"] = pool
        return self._subkey(addr), kw

    def trace(self, gen_fn, args, addr):
        return self.trace_call(gen_fn, args, addr)


class SimulateHandler(_Handler):
    """``simulate``: every site draws."""

    def sample(self, dist, params, addr):
        x = self._draw(dist, params, addr)
        self.tr.data.w_observe(addr, x, dist.logpdf(x, params), dist)
        return x

    def factor(self, logp, addr):
        self.tr.data.w_observe(addr, (), logp)

    def trace_call(self, gen_fn, args, addr):
        k, kw = self._sub(addr)
        subtrace = gen_fn.simulate(k, args, **kw)
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv


class GenerateHandler(_Handler):
    """``generate``: constrained sites score and add to the weight;
    unconstrained sites draw fresh values."""

    def __init__(self, key, trace, constraints, dtype, device, pool=None):
        super().__init__(key, trace, dtype, device, pool)
        self.constraints = constraints
        self.weight = 0.0

    def sample(self, dist, params, addr):
        choice = self.constraints.remove(addr)
        if choice is not None:
            x = choice.expect_inner(f"error: no value found in {addr}")
            logp = dist.logpdf(x, params)
            self.weight = self.weight + logp
        else:
            x = self._draw(dist, params, addr)
            logp = dist.logpdf(x, params)
        self.tr.data.w_observe(addr, x, logp, dist)
        return x

    def factor(self, logp, addr):
        self.constraints.remove(addr)  # a factor is never "unconsumed"
        self.tr.data.w_observe(addr, (), logp)
        self.weight = self.weight + logp

    def trace_call(self, gen_fn, args, addr):
        choices = self.constraints.remove(addr)
        k, kw = self._sub(addr)
        if choices is not None:
            subtrace, d_weight = gen_fn.generate(k, args, choices, **kw)
            self.weight = self.weight + d_weight
        else:
            subtrace = gen_fn.simulate(k, args, **kw)
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv


class UpdateHandler(_Handler):
    """``update``. ``diff`` is shared state: once a site is constrained or
    freshly drawn it becomes UNKNOWN, and every later site rescores."""

    def __init__(self, key, trace, diff, constraints, dtype, device,
                 pool=None):
        super().__init__(key, trace, dtype, device, pool)
        self.diff = diff
        self.constraints = constraints
        self.weight = 0.0
        self.discard = Trie()
        self.visitor = Selection()

    def sample(self, dist, params, addr):
        self.visitor.visit(addr)
        choice = self.constraints.remove(addr)
        prev = self.tr.data.remove(addr)
        if choice is not None:
            if prev is not None:
                self.weight = self.weight - prev.weight()
                self.discard.insert(addr, prev)
            x = choice.expect_inner(f"error: no value found in {addr}")
            logp = dist.logpdf(x, params)
            self.diff = ArgDiff.UNKNOWN
            self.weight = self.weight + logp
        elif prev is not None:
            x = prev.expect_inner(f"error: no value found in {addr}")
            if self.diff is ArgDiff.NO_CHANGE:
                # the value and its stored logp are reused, no rescore
                self.tr.data.insert(addr, prev)
                return x
            if self.diff is not ArgDiff.UNKNOWN:
                raise ValueError("update: ArgDiff.EXTEND not supported")
            logp = dist.logpdf(x, params)
            self.weight = self.weight + logp - prev.weight()
        else:
            x = self._draw(dist, params, addr)
            logp = dist.logpdf(x, params)
            self.diff = ArgDiff.UNKNOWN
        self.tr.data.w_observe(addr, x, logp, dist)
        return x

    def factor(self, logp, addr):
        self.visitor.visit(addr)
        self.constraints.remove(addr)
        prev = self.tr.data.remove(addr)
        prev_logp = prev.weight() if prev is not None else 0.0
        self.tr.data.w_observe(addr, (), logp)
        self.weight = self.weight + logp - prev_logp

    def trace_call(self, gen_fn, args, addr):
        self.visitor.visit(addr)
        choices = self.constraints.remove(addr)
        k, kw = self._sub(addr)
        prev = self.tr.data.remove(addr)
        if choices is not None:
            if prev is not None:
                subtrace, subdiscard, d_weight = gen_fn.update(
                    k, Trace(args, prev, None, prev.weight()), args,
                    self.diff, choices, **kw)
                if not subdiscard.is_empty():
                    self.discard.insert(addr, subdiscard)
            else:
                subtrace, d_weight = gen_fn.generate(k, args, choices, **kw)
            self.diff = ArgDiff.UNKNOWN
            self.weight = self.weight + d_weight
        elif prev is not None:
            if self.diff is ArgDiff.NO_CHANGE:
                retv = prev.expect_inner(f"error: no value found in {addr}")
                self.tr.data.insert(addr, prev)
                return retv
            if self.diff is not ArgDiff.UNKNOWN:
                raise ValueError("update: ArgDiff.EXTEND not supported")
            subtrace, subdiscard, d_weight = gen_fn.update(
                k, Trace(args, prev, None, prev.weight()), args,
                ArgDiff.UNKNOWN, Trie(), **kw)
            if not subdiscard.is_empty():
                self.discard.insert(addr, subdiscard)
            self.weight = self.weight + d_weight
        else:
            subtrace = gen_fn.simulate(k, args, **kw)
            self.diff = ArgDiff.UNKNOWN
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv

    def gc(self):
        """Unvisited addresses move to the discard; their weight is
        subtracted."""
        schema = self.tr.data.schema()
        data, complement, complement_weight = self.tr.data.collect(
            schema.complement(self.visitor))
        assert self.visitor.all_visited(data.schema())
        self.tr.data = data
        self.discard.merge(complement)
        self.weight = self.weight - complement_weight


class RegenerateHandler(_Handler):
    """``regenerate``: sites under the mask draw afresh (their prior cancels
    from the weight); the others keep their values and, once ``diff`` is
    UNKNOWN, rescore."""

    def __init__(self, key, trace, diff, mask, dtype, device, pool=None):
        super().__init__(key, trace, dtype, device, pool)
        self.diff = diff
        self.mask = mask
        self.weight = 0.0
        self.visitor = Selection()

    def sample(self, dist, params, addr):
        self.visitor.visit(addr)
        prev = self.tr.data.remove(addr)
        if self.mask.search(addr) is not None or prev is None:
            x = self._draw(dist, params, addr)
            logp = dist.logpdf(x, params)
            self.diff = ArgDiff.UNKNOWN
        else:
            x = prev.expect_inner(f"error: no value found in {addr}")
            if self.diff is ArgDiff.NO_CHANGE:
                self.tr.data.insert(addr, prev)
                return x
            if self.diff is not ArgDiff.UNKNOWN:
                raise ValueError("regenerate: ArgDiff.EXTEND not supported")
            logp = dist.logpdf(x, params)
            self.weight = self.weight + logp - prev.weight()
        self.tr.data.w_observe(addr, x, logp, dist)
        return x

    def factor(self, logp, addr):
        self.visitor.visit(addr)
        prev = self.tr.data.remove(addr)
        prev_logp = prev.weight() if prev is not None else 0.0
        self.tr.data.w_observe(addr, (), logp)
        self.weight = self.weight + logp - prev_logp

    def trace_call(self, gen_fn, args, addr):
        self.visitor.visit(addr)
        submask = self.mask.search(addr)
        k, kw = self._sub(addr)
        prev = self.tr.data.remove(addr)
        if prev is None:
            subtrace = gen_fn.simulate(k, args, **kw)
            self.diff = ArgDiff.UNKNOWN
        elif submask is not None:
            subtrace, d_weight = gen_fn.regenerate(
                k, Trace(args, prev, None, prev.weight()), args, self.diff,
                submask, **kw)
            self.diff = ArgDiff.UNKNOWN
            self.weight = self.weight + d_weight
        elif self.diff is ArgDiff.NO_CHANGE:
            retv = prev.expect_inner(f"error: no value found in {addr}")
            self.tr.data.insert(addr, prev)
            return retv
        elif self.diff is ArgDiff.UNKNOWN:
            prev_weight = prev.weight()
            subtrace, new_weight = gen_fn.generate(k, args, prev, **kw)
            self.weight = self.weight + new_weight - prev_weight
        else:
            raise ValueError("regenerate: ArgDiff.EXTEND not supported")
        sub = subtrace.data
        sub.replace_inner(subtrace.retv)
        self.tr.data.insert(addr, sub)
        return subtrace.retv

    def gc(self):
        """Drop unvisited addresses; the weight is untouched."""
        schema = self.tr.data.schema()
        data, _, _ = self.tr.data.collect(schema.complement(self.visitor))
        assert self.visitor.all_visited(data.schema())
        self.tr.data = data
