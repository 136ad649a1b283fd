"""The eager particle filter: ``ParticleSystem`` (counterpart of
modppl_tpu/inference/smc.py:26-93).

Generic over any GenFn whose args are ``(t, args)``: a trie model, a
hand-coded GenFn with list data (``models/hmm.HMM``) or an ``Unfold``. One
trace a particle, one ``generate`` or ``update`` a particle and step, so
it is host-bound by design; the batched filters are inference/vsmc.py and
parallel/sharded_smc.py. Its host syncs are the reference's: one read of
the N parents a resample (one ``.tolist()``), plus whatever the model
reads (a Python-int ``t`` needs none).
"""

import math

import torch

from modppl_tpu_torch.core.gfi import ArgDiff
from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.dists import categorical
from modppl_tpu_torch.modeling.handlers import entry_device, to_device
from modppl_tpu_torch.utils.numerics import (
    effective_sample_size_from_log_weights,
    logsumexp,
)


class ParticleSystem:
    """Basic particle filter over a GenFn with args ``(t, args)``, on
    ``device`` (the card unless the caller passes ``device="cpu"``; the
    args and constraints are moved there)."""

    def __init__(self, model, num_particles, key, device=None):
        self.device = entry_device(device, "ParticleSystem")
        self.num_particles = num_particles
        self.model = model
        self.key = key
        self.traces = []
        self.log_weights = torch.zeros(num_particles, device=self.device)
        self.log_ml_estimate = 0.0

    def _next_key(self, n=1):
        self.key, *keys = split(self.key, n + 1)
        return keys if n > 1 else keys[0]

    def _weights(self, ws):
        return torch.stack([torch.as_tensor(w, device=self.device)
                            for w in ws])

    def init_step(self, args, constraints):
        """N traces from ``generate((1, args), constraints)``."""
        args = to_device(args, self.device)
        constraints = to_device(constraints, self.device)
        keys = self._next_key(self.num_particles)
        ws = []
        for i in range(self.num_particles):
            trace, w = self.model.generate(keys[i], (1, args), constraints,
                                           device=self.device)
            self.traces.append(trace)
            ws.append(w)
        self.log_weights = self._weights(ws)

    def step(self, constraints):
        """Extend every particle from t to t + 1 under ``constraints``."""
        constraints = to_device(constraints, self.device)
        keys = self._next_key(self.num_particles)
        new_traces, increments = [], []
        for i, trace in enumerate(self.traces):
            t, args = trace.args
            new_trace, _, w = self.model.update(
                keys[i], trace, (t + 1, args), ArgDiff.EXTEND, constraints,
                device=self.device)
            new_traces.append(new_trace)
            increments.append(w)
        self.traces = new_traces
        self.log_weights = self.log_weights + self._weights(increments)
        return self

    def _log_normalized_weights(self):
        return self.log_weights - logsumexp(self.log_weights)

    def effective_sample_size(self):
        return effective_sample_size_from_log_weights(
            self._log_normalized_weights())

    def resample(self):
        """Multinomial resampling; returns the log total weight."""
        n = self.num_particles
        log_total_weight = logsumexp(self.log_weights)
        log_normalized = self.log_weights - log_total_weight
        self.log_ml_estimate = (self.log_ml_estimate + log_total_weight
                                - math.log(n))
        weights = torch.exp(log_normalized)
        parents = categorical.sample_batch(
            generator(self._next_key(), weights.device), (n,), (weights,))
        # one device-to-host read of the parents, then N trace copies
        self.traces = [self.traces[p].copy() for p in parents.tolist()]
        self.log_weights = torch.zeros_like(self.log_weights)
        return log_total_weight

    def log_marginal_likelihood_estimate(self):
        return (self.log_ml_estimate + logsumexp(self.log_weights)
                - math.log(self.num_particles))
