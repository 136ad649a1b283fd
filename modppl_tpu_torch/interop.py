"""Carry the JAX package's values into the port.

Takes values as numpy arrays (``np.asarray`` of the reference's arrays) and
turns them into the port's tensors on a given device, so a test can hand
both sides the same inputs. Imports neither jax nor modppl_tpu. For HMC:
``quadratic_from_numpy`` carries a detected (Λ, b), ``phase_streams`` a
phase's pre-drawn randoms for the chunk kernels, ``pooled_phase_draws``
and ``chain_phase_draws`` the generic path's (a pooled phase's
``_phase_randoms`` segments, a phase's per-chain transition draws),
``chees_phase_draws`` a ChEES phase's (momenta and accept uniforms), and
``logreg_data_from_numpy`` a logistic-regression dataset; start positions
and an adapted (eps, inv_mass) go through ``tensor``. For the filters:
``hmm_params_from_numpy`` and ``lgssm_params_from_numpy`` carry a model's
parameters. For importance sampling and MH: ``pool_from_reference`` turns
a reference batched trace's choices into the port's ``pool=`` dict,
``trace_from_reference`` / ``trie_from_reference`` carry an eager trace
(trie, tuple or list data) or a choice map, ``bounds_from_reference`` the
pointed model's ``Bounds``. These take the reference's objects as they
are, by their attributes (a trie's ``children``, ``inner()`` and
``logp``), and read its arrays with ``np.asarray``.
"""

import numpy as np
import torch

from modppl_tpu_torch.core.gfi import Trace
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.vsmc import SMCState


def tensor(x, device="cpu"):
    """A numpy array (or number) as a tensor of the same dtype on ``device``."""
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def trie_from_numpy(d, device="cpu"):
    """The port's Trie from a nested dict {component: array | dict}, the
    form ``Trie.from_dict`` takes on the JAX side."""
    return Trie.from_dict(_to_tensors(d, device))


def _to_tensors(d, device):
    return {k: _to_tensors(v, device) if isinstance(v, dict)
            else tensor(v, device) for k, v in d.items()}


def trie_to_numpy(trie):
    """Nested dict of numpy arrays from the port's Trie (the inverse)."""
    out = {}
    for k, sub in trie.children.items():
        out[k] = (sub.inner().cpu().numpy() if sub.is_leaf()
                  else trie_to_numpy(sub))
    return out


def quadratic_from_numpy(lam, b, device="cpu"):
    """The quadratic form (Λ (d, d), b (d,)) of a target the reference
    detected (``detect_quadratic_target``), as the port's tensors."""
    return tensor(lam, device), tensor(b, device)


def phase_streams(z, jit, u01, device="cpu"):
    """One HMC phase's pre-drawn streams, as the reference's chunk wrappers
    draw them from ``jax.random.split(key, 3)``: standard normals z
    (T, N, d), step-size jitters in [0.5, 1.5) and accept uniforms, each
    (T, N) or (T, N, 1) (the d <= 12 wrappers draw the latter). Returns the
    (z, jit, u01) the port's chunk entries take as ``draws``."""
    z = np.asarray(z)
    lead = z.shape[:2]
    return (tensor(z, device), tensor(np.reshape(jit, lead), device),
            tensor(np.reshape(u01, lead), device))


def pooled_phase_draws(segments, device="cpu"):
    """One phase of the reference's generic pooled path as the port's
    ``draws`` entry: ``segments`` are the phase's ``_phase_randoms``
    results in order, each (momenta (W, C, d), jitters (W, C), accept
    uniforms (W, C)); they are joined along the iteration axis."""
    return tuple(tensor(np.concatenate([np.asarray(s[i]) for s in segments]),
                        device) for i in range(3))


def chees_phase_draws(segments, device="cpu"):
    """One phase of the reference's ChEES pipeline as the port's ``draws``
    entry (``chees_runner``'s ``run.chains``): ``segments`` are the phase's
    ``chees._phase_randoms`` results in order, each (momenta (W, C, d),
    accept uniforms (W, C)); they are joined along the iteration axis."""
    return tuple(tensor(np.concatenate([np.asarray(s[i]) for s in segments]),
                        device) for i in range(2))


def chain_phase_draws(mom, acc, jit, device="cpu"):
    """One phase of the reference's per-chain path as the port's ``draws``
    entry. ``mom`` (C, T, d), ``acc`` (C, T) and ``jit`` (C, T) are what
    each chain's ``hmc_transition`` draws from ``split(key, 3)`` (momentum
    normals, accept uniform, step-size jitter), stacked over the chain's
    iterations and over the chains; returns (z (T, C, d), jit (T, C), u01
    (T, C))."""
    return (tensor(np.swapaxes(np.asarray(mom), 0, 1), device),
            tensor(np.swapaxes(np.asarray(jit), 0, 1), device),
            tensor(np.swapaxes(np.asarray(acc), 0, 1), device))


def logreg_data_from_numpy(X, ys, device="cpu"):
    """A logistic-regression dataset (X (n, d), ys (n,)) as the port's
    tensors, in their dtype on ``device``."""
    return tensor(X, device), tensor(ys, device)


def hmm_params_from_numpy(prior, emission_matrix, transition_matrix,
                          device="cpu"):
    """The port's HMMParams from the reference's ``HMMParams`` arrays
    (``np.asarray(params.prior)`` and so on), in their dtype on ``device``."""
    from modppl_tpu_torch.models.hmm import HMMParams

    return HMMParams(tensor(prior, device), tensor(emission_matrix, device),
                     tensor(transition_matrix, device))


def lgssm_params_from_numpy(A, Q, H, R, mu0, P0, device="cpu"):
    """The port's LGSSMParams from the reference's ``LGSSMParams`` arrays
    (``np.asarray(params.A)`` and so on), in their dtype on ``device``."""
    from modppl_tpu_torch.models.lgssm import LGSSMParams

    return LGSSMParams(*(tensor(x, device) for x in (A, Q, H, R, mu0, P0)))


def smc_state_from_numpy(key, state, log_weights, log_ml, t, device="cpu"):
    """The port's SMCState from the reference's ``state``, ``log_weights``,
    ``log_ml`` and ``t`` as numpy values. ``key`` is the port's integer
    key: a threefry key has no counterpart to carry."""
    state = (tensor(state, device) if not isinstance(state, (tuple, list))
             else type(state)(tensor(x, device) for x in state))
    return SMCState(key, state, tensor(log_weights, device),
                    tensor(log_ml, device), int(t))


def _is_trie(x):
    return hasattr(x, "children") and hasattr(x, "inner")


def trie_from_reference(t, device="cpu"):
    """The port's Trie from a reference Trie: every value and leaf
    log-probability (the leaves' distributions are not carried)."""
    out = Trie()
    if t.has_inner():
        out.value = from_reference(t.inner(), device)
    out.logp = from_reference(t.logp, device)
    out.children = {k: trie_from_reference(sub, device)
                    for k, sub in t.children.items()}
    return out


def from_reference(x, device="cpu"):
    """A reference value as the port's: a Trie, a Trace or ``Bounds``
    through their converters, tuples and lists element by element, Python
    numbers and None as they are, arrays as tensors of their dtype."""
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if _is_trie(x):
        return trie_from_reference(x, device)
    if all(hasattr(x, a) for a in ("args", "data", "retv", "logjp")):
        return trace_from_reference(x, device)
    if all(hasattr(x, a) for a in ("xmin", "xmax", "ymin", "ymax")):
        return bounds_from_reference(x)
    if isinstance(x, (tuple, list)):
        return type(x)(from_reference(v, device) for v in x)
    return tensor(np.asarray(x), device)


def trace_from_reference(tr, device="cpu"):
    """The port's Trace from a reference eager Trace (trie, tuple or list
    data): args, data, return value and log-joint."""
    return Trace(from_reference(tr.args, device),
                 from_reference(tr.data, device),
                 from_reference(tr.retv, device),
                 from_reference(tr.logjp, device))


def bounds_from_reference(b):
    """The port's ``Bounds`` from the reference's."""
    from modppl_tpu_torch.models.simple import Bounds

    return Bounds(float(b.xmin), float(b.xmax), float(b.ymin), float(b.ymax))


def pool_from_reference(t, device="cpu", prefix=""):
    """``{address: value}`` of every leaf of a reference trie (a batched
    trace's ``data``: each value (N, ...)), addresses in normal form
    (``"coeffs / a"``): the port's ``pool=``."""
    out = {}
    for k, sub in t.children.items():
        addr = k if not prefix else f"{prefix} / {k}"
        if sub.has_inner():
            out[addr] = tensor(np.asarray(sub.inner()), device)
        out.update(pool_from_reference(sub, device, addr))
    return out
