"""Hand-coded GenFns with tuple data (counterpart of
modppl_tpu/models/pointed.py): the inference library runs a model whose
data is ``(latent | None, obs | None)`` with no trie.

Model: latent ~ Uniform2D(bounds); obs ~ MvNormal(latent, obs_cov). Its
args are the ``Bounds``. ``batch_generate`` is its batch-aware generate:
``n`` traces at once over a leading lane axis, what
``importance_sampling(..., vectorized=True)`` calls.

Each method runs on ``device`` when the caller names one, else on the
device of the tensors it is given (the covariance, the constraints or the
previous trace).
"""

import torch

from modppl_tpu_torch.core.gfi import ArgDiff, GenFn, Trace
from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.dists import mvnormal
from modppl_tpu_torch.modeling.handlers import infer_dtype_device
from modppl_tpu_torch.models.simple import uniform_2d


class PointedModel(GenFn):
    """Uniform latent point, mvnormal observation; tuple data."""

    def __init__(self, obs_cov):
        self.obs_cov = obs_cov

    def _where(self, device, *values):
        return infer_dtype_device((self.obs_cov,) + values, device)

    def simulate(self, key, bounds, device=None):
        dtype, device = self._where(device)
        k1, k2 = split(key)
        latent = uniform_2d.sample(generator(k1, device), bounds, dtype=dtype)
        logjp = uniform_2d.logpdf(latent, bounds)
        obs = mvnormal.sample(generator(k2, device), (latent, self.obs_cov))
        logjp = logjp + mvnormal.logpdf(obs, (latent, self.obs_cov))
        return Trace(bounds, (latent, obs), obs, logjp)

    def generate(self, key, bounds, constraints, device=None):
        return self.batch_generate(key, bounds, constraints, None,
                                   device=device)

    def batch_generate(self, key, bounds, constraints, n, device=None,
                       pool=None):
        """``generate`` of ``n`` traces over a leading lane axis (one trace
        when ``n`` is None): a constrained site's value is broadcast to the
        lanes, an unconstrained one drawn for each lane (or taken from
        ``pool["latent"]`` / ``pool["obs"]``). Returns (trace, weight),
        both per lane."""
        latent_constraint, obs_constraint = constraints
        dtype, device = self._where(device, latent_constraint, obs_constraint)
        pool = pool or {}
        k1, k2 = split(key)
        lanes = () if n is None else (n,)
        weight = 0.0

        if latent_constraint is not None:
            latent = latent_constraint.expand(lanes + (2,))
            logjp = uniform_2d.logpdf(latent, bounds)
            weight = weight + logjp
        else:
            latent = pool.get("latent")
            if latent is None:
                latent = uniform_2d.sample_batch(generator(k1, device), lanes,
                                                 bounds, dtype=dtype)
            logjp = uniform_2d.logpdf(latent, bounds)

        if obs_constraint is not None:
            obs = obs_constraint.expand(lanes + (2,))
            w = mvnormal.logpdf(obs, (latent, self.obs_cov))
            weight = weight + w
        else:
            obs = pool.get("obs")
            if obs is None:
                obs = mvnormal.sample(generator(k2, device),
                                      (latent, self.obs_cov))
            w = mvnormal.logpdf(obs, (latent, self.obs_cov))
        logjp = logjp + w
        return Trace(bounds, (latent, obs), obs, logjp), weight

    def update(self, key, trace, args, argdiff, constraints, device=None):
        """NO_CHANGE only: the constrained sites take their new values,
        the others keep theirs. Returns (trace, discard, weight), the
        discard a tuple holding the replaced values."""
        if argdiff is not ArgDiff.NO_CHANGE:
            raise ValueError(
                f"PointedModel.update: can't handle ArgDiff {argdiff}")
        prev_latent, prev_obs = trace.data
        bounds = trace.args
        discard = [None, None]
        new_logjp = trace.logjp
        visited_obs = False

        latent = prev_latent
        if constraints[0] is not None:
            discard[0] = prev_latent
            latent = constraints[0]
            new_logjp = new_logjp - uniform_2d.logpdf(prev_latent, bounds)
            new_logjp = new_logjp + uniform_2d.logpdf(latent, bounds)
            visited_obs = True
            new_logjp = new_logjp - mvnormal.logpdf(
                prev_obs, (prev_latent, self.obs_cov))

        obs = prev_obs
        if constraints[1] is not None:
            discard[1] = prev_obs
            obs = constraints[1]
            if not visited_obs:
                new_logjp = new_logjp - mvnormal.logpdf(
                    prev_obs, (prev_latent, self.obs_cov))
            new_logjp = new_logjp + mvnormal.logpdf(obs,
                                                    (latent, self.obs_cov))
        elif visited_obs:
            new_logjp = new_logjp + mvnormal.logpdf(obs,
                                                    (latent, self.obs_cov))

        new_trace = Trace(args, (latent, obs), obs, new_logjp)
        return new_trace, tuple(discard), new_logjp - trace.logjp


class DriftProposal(GenFn):
    """Gaussian drift of the latent, tuple data; args ``(prev_trace,)``."""

    def __init__(self, drift_cov):
        self.drift_cov = drift_cov

    def simulate(self, key, args, device=None):
        prev_trace = args[0]
        prev_latent = prev_trace.data[0]
        new_latent = mvnormal.sample(generator(key, prev_latent.device),
                                     (prev_latent, self.drift_cov))
        logp = mvnormal.logpdf(new_latent, (prev_latent, self.drift_cov))
        return Trace(args, (new_latent, prev_trace.data[1]), None, logp)

    def generate(self, key, args, constraints, device=None):
        prev_trace = args[0]
        prev_latent = prev_trace.data[0]
        weight = 0.0
        if constraints[0] is not None:
            new_latent = constraints[0]
            logp = mvnormal.logpdf(new_latent, (prev_latent, self.drift_cov))
            weight = logp
        else:
            new_latent = mvnormal.sample(generator(key, prev_latent.device),
                                         (prev_latent, self.drift_cov))
            logp = mvnormal.logpdf(new_latent, (prev_latent, self.drift_cov))
        return Trace(args, (new_latent, prev_trace.data[1]), None,
                     logp), weight
