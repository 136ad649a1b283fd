"""Bayesian logistic regression: the non-quadratic HMC target (counterpart
of modppl_tpu/models/logreg.py).

A standard-normal prior over the weights (one ``iid`` plate address "w")
and a Bernoulli likelihood through a numerically stable log-sigmoid
``factor``. The unconstrained log-joint is smooth, unimodal and not
quadratic (``detect_quadratic_target`` rejects it), so HMC takes the
generic path. Batched over chains, the model's hot op is a (chains, dim) x
(dim, n_data) product in the forward and the gradient pass.
"""

import numpy as np
import torch
import torch.nn.functional as F

from modppl_tpu_torch.core.keys import generator, split
from modppl_tpu_torch.dists import iid, normal
from modppl_tpu_torch.modeling import gen


def _loglik(X, ys, w):
    logits = X @ w
    return torch.sum(ys * F.logsigmoid(logits)
                     + (1.0 - ys) * F.logsigmoid(-logits)), logits


def make_logreg(dim):
    """Model over args (X (n, dim), ys (n,)) with latent address "w"."""
    w_dist = iid(normal, dim)

    @gen
    def logreg(h, X, ys):
        w = h.sample(w_dist, (0.0, 1.0), "w")
        ll, logits = _loglik(X, ys, w)
        h.factor(ll, "loglik")
        return logits

    return logreg


def make_logreg_minibatch(dim, X, ys):
    """The variant for subsampled-ELBO VI: the model closes over the FULL
    data, takes one argument ``idx`` (B,) of row indices, and scales the
    batch log-likelihood by n / B, unbiased under choice with
    replacement."""
    w_dist = iid(normal, dim)
    scale = X.shape[0]

    @gen
    def logreg_mb(h, idx):
        w = h.sample(w_dist, (0.0, 1.0), "w")
        ll, logits = _loglik(X[idx], ys[idx], w)
        h.factor(ll * (scale / idx.shape[0]), "loglik")
        return logits

    return logreg_mb


def simulate_logreg(key, n, dim, w_true=None, *, device,
                    dtype=torch.float32):
    """Draw (X, ys, w_true) on ``device`` from the port's integer ``key``:
    X ~ N(0, 1) features, w_true ~ N(0, 1) unless given, ys ~
    Bernoulli(sigmoid(X w_true)) as 0/1 floats. The draws are torch's, not
    the reference's threefry ones."""
    k_x, k_w, k_y = split(key, 3)
    kw = dict(dtype=dtype, device=device)
    X = torch.randn((n, dim), generator=generator(k_x, device), **kw)
    if w_true is None:
        w_true = torch.randn(dim, generator=generator(k_w, device), **kw)
    w_true = torch.as_tensor(w_true, **kw)
    p = torch.sigmoid(X @ w_true)
    u = torch.rand(n, generator=generator(k_y, device), **kw)
    return X, (u < p).to(dtype), w_true


def map_newton(X, ys, num_iters=50):
    """MAP weights (the penalized MLE under the N(0, 1) prior) by Newton
    iteration in float64 numpy: the oracle the posterior-mean checks use
    (for n >> dim the posterior is close to Gaussian around this mode)."""
    X = np.asarray(X, np.float64)
    ys = np.asarray(ys, np.float64)
    d = X.shape[1]
    w = np.zeros(d)
    for _ in range(num_iters):
        p = 1.0 / (1.0 + np.exp(-X @ w))
        g = X.T @ (ys - p) - w            # + standard-normal prior grad
        H = -(X.T * (p * (1 - p))) @ X - np.eye(d)
        w = w - np.linalg.solve(H, g)
    return w
