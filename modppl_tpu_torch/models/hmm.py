"""Hidden Markov model for the batched filter, and the exact forward
algorithm as its oracle, sequential and time-parallel (counterpart of
modppl_tpu/models/hmm.py).

Matrix conventions follow the reference: ``emission_matrix[obs, state]``,
``transition_matrix[new_state, prev_state]``. ``HMM`` is the hand-coded
sequential GenFn of the eager particle filter (inference/smc.py,
modppl_tpu/models/hmm.py:117-156).

The scan kernel's body runs once on the particle-batched state (``z_prev``
of shape (n,), modeling/autobatch.py), so it indexes the trailing axis:
``transition_matrix.T[z_prev]`` is each particle's (K,) row of next-state
probabilities, an (n, K) tensor. The reference's ``transition_matrix[:,
z_prev]`` is the same row for one particle under ``vmap``, but on an (n,)
index it would be (K, n).
"""

import torch

from modppl_tpu_torch.core.gfi import ArgDiff, GenFn, Trace
from modppl_tpu_torch.core.keys import generator
from modppl_tpu_torch.dists import categorical
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.handlers import entry_device


class HMMParams:
    """Prior (K,), emission (M, K) and transition (K, K) probabilities, as
    tensors on the device the filter runs on."""

    def __init__(self, prior, emission_matrix, transition_matrix):
        self.prior = torch.as_tensor(prior)
        self.emission_matrix = torch.as_tensor(emission_matrix)
        self.transition_matrix = torch.as_tensor(transition_matrix)


class HMM(GenFn):
    """The HMM as a hand-coded GenFn over args ``(t, _)`` and data
    ``(states, observations)``, two lists: ``generate`` initializes (T = 1
    only) and ``update`` appends one step (``ArgDiff.EXTEND`` only). The
    constraints are ``(states, observations)`` lists too; the last
    observation is the step's. It runs on its parameters' device."""

    def __init__(self, params):
        self.params = params

    def _kernel(self, key, data, state_probs, new_observation):
        # sample the new state, score the observation
        new_state = categorical.sample(generator(key, state_probs.device),
                                       (state_probs,))
        obs_probs = self.params.emission_matrix[:, new_state]
        states, observations = data
        data = (states + [new_state], observations + [new_observation])
        weight = categorical.logpdf(new_observation, (obs_probs,))
        return data, weight

    def simulate(self, key, args, device=None):
        raise NotImplementedError("HMM: simulate not implemented")

    def generate(self, key, args, constraints, device=None):
        t, _ = args
        if t != 1:
            raise ValueError(
                "HMM.generate: only expect generate to initialize (T = 1)")
        new_observation = constraints[1][0]
        data, weight = self._kernel(key, ([], []), self.params.prior,
                                    new_observation)
        return Trace(args, data, list(data[1]), weight), weight

    def update(self, key, trace, args, argdiff, constraints, device=None):
        if argdiff is not ArgDiff.EXTEND:
            raise ValueError(f"HMM.update: can't handle ArgDiff {argdiff}")
        new_observation = constraints[1][-1]
        prev_state = trace.data[0][-1]
        state_probs = self.params.transition_matrix[:, prev_state]
        data, weight = self._kernel(key, trace.data, state_probs,
                                    new_observation)
        new_trace = Trace((trace.args[0] + 1, trace.args[1]), data,
                          list(data[1]), trace.logjp + weight)
        return new_trace, ([], []), weight


def _f64(x):
    return torch.as_tensor(x).to(device="cpu", dtype=torch.float64)


def hmm_forward_alg(prior, emission_dists, transition_dists, observations):
    """Exact marginal likelihood of ``observations``, in float64 on the CPU
    (hmm/forward.rs:3-23)."""
    alpha = _f64(prior)
    emission, transition = _f64(emission_dists), _f64(transition_dists)
    marginal_likelihood = torch.ones((), dtype=torch.float64)
    for obs in observations:
        posterior = alpha * emission[int(obs), :]
        evidence = torch.sum(posterior)
        alpha = transition @ (posterior / evidence)
        marginal_likelihood = marginal_likelihood * evidence
    return marginal_likelihood


def hmm_forward_log_ml(prior, emission_dists, transition_dists, observations):
    """Log marginal likelihood by the forward recursion in log space, in
    float64 on the CPU: the filter's oracle."""
    log_alpha = torch.log(_f64(prior))
    log_e, log_t = torch.log(_f64(emission_dists)), torch.log(
        _f64(transition_dists))
    total = torch.zeros((), dtype=torch.float64)
    for obs in observations:
        scored = log_alpha + log_e[int(obs), :]
        evidence = torch.logsumexp(scored, 0)
        log_alpha = torch.logsumexp(log_t + (scored - evidence)[None, :], 1)
        total = total + evidence
    return total


def hmm_forward_log_ml_parallel(prior, emission_dists, transition_dists,
                                observations, device=None):
    """Log marginal likelihood by the time-parallel forward algorithm, in
    the inputs' dtype on the card unless ``device`` names another
    (``device="cpu"``).

    The recursion alpha_t = diag(e[obs_t]) T alpha_{t-1} is a chain of
    (K, K) products, which compose associatively: their prefix products
    run in O(log T) depth (``inference/kalman.associative_scan``, the
    reference's odd-even scheme), each product max-normalized with its log
    scale carried apart, so nothing underflows. The log-ML is the summed
    scale plus the final reduction against alpha_0. Torch has no
    ``associative_scan``; this is plain torch, as the reference's is XLA.
    """
    from modppl_tpu_torch.inference.kalman import associative_scan

    device = entry_device(device, "hmm_forward_log_ml_parallel")
    prior = torch.as_tensor(prior, device=device)
    e = torch.as_tensor(emission_dists, device=device)
    t_mat = torch.as_tensor(transition_dists, device=device)
    obs = torch.as_tensor(observations, device=device).long()

    alpha0 = e[obs[0], :] * prior
    if obs.shape[0] == 1:
        return torch.log(torch.sum(alpha0))
    # M_t = diag(e[obs_t]) T for t = 1 .. T-1
    ms = e[obs[1:]][:, :, None] * t_mat[None, :, :]
    norms = torch.amax(ms, dim=(1, 2))

    def assoc(earlier, later):
        # the later range's product on the LEFT, normalized per element
        se, me = earlier
        sl, ml = later
        m = ml @ me
        norm = torch.amax(m, dim=(-2, -1), keepdim=True)
        return se + sl + torch.log(norm[..., 0, 0]), m / norm

    s_fin, m_fin = associative_scan(
        assoc, (torch.log(norms), ms / norms[:, None, None]))
    return s_fin[-1] + torch.log(torch.sum(m_fin[-1] @ alpha0))


def hmm_scan_kernel(params):
    """The HMM as a ScanKernel of @gen functions: a state ``z`` and an
    observation ``obs``, both categorical, per step."""
    from modppl_tpu_torch.inference.vsmc import ScanKernel

    emission_t = params.emission_matrix.T       # [state] -> (M,) obs probs
    transition_t = params.transition_matrix.T   # [prev] -> (K,) next probs

    @gen
    def init(h, _state0):
        z = h.sample(categorical, (params.prior,), "z")
        h.sample(categorical, (emission_t[z],), "obs")
        return z

    @gen
    def step(h, t, z_prev):
        z = h.sample(categorical, (transition_t[z_prev],), "z")
        h.sample(categorical, (emission_t[z],), "obs")
        return z

    return ScanKernel(init, step)
