"""Hidden Markov model for the batched filter, and the exact forward
algorithm as its oracle (counterpart of modppl_tpu/models/hmm.py:18-60,
108-114, 159-182).

Matrix conventions follow the reference: ``emission_matrix[obs, state]``,
``transition_matrix[new_state, prev_state]``. The hand-coded sequential
``HMM`` GenFn belongs with the eager tier that uses it and is not ported yet
(ROADMAP Queue 1 item 9).

The scan kernel's body runs once on the particle-batched state (``z_prev``
of shape (n,), modeling/autobatch.py), so it indexes the trailing axis:
``transition_matrix.T[z_prev]`` is each particle's (K,) row of next-state
probabilities, an (n, K) tensor. The reference's ``transition_matrix[:,
z_prev]`` is the same row for one particle under ``vmap``, but on an (n,)
index it would be (K, n).
"""

import torch

from modppl_tpu_torch.dists import categorical
from modppl_tpu_torch.modeling import gen


class HMMParams:
    """Prior (K,), emission (M, K) and transition (K, K) probabilities, as
    tensors on the device the filter runs on."""

    def __init__(self, prior, emission_matrix, transition_matrix):
        self.prior = torch.as_tensor(prior)
        self.emission_matrix = torch.as_tensor(emission_matrix)
        self.transition_matrix = torch.as_tensor(transition_matrix)


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
