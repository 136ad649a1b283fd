"""Convergence diagnostics on numpy arrays (counterpart of
modppl_tpu/utils/diagnostics.py:17-61)."""

import numpy as np


def split_rhat(samples):
    """Split-chain potential scale reduction (Gelman-Rubin, split version).

    samples: array (chains, draws) or (chains, draws, ...), per trailing
    component. Values near 1.0 indicate convergence.
    """
    x = np.asarray(samples)
    n = x.shape[1]
    half = n // 2
    halves = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    n2 = halves.shape[1]
    chain_means = halves.mean(axis=1)
    chain_vars = halves.var(axis=1, ddof=1)
    w = chain_vars.mean(axis=0)
    b = n2 * chain_means.var(axis=0, ddof=1)
    var_plus = (n2 - 1) / n2 * w + b / n2
    return np.sqrt(var_plus / np.where(w > 0, w, 1.0))


def ess_autocorr(samples):
    """Effective sample size via Geyer's initial monotone sequence.

    samples: (chains, draws); returns the ESS pooled over chains.
    """
    x = np.asarray(samples, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    c, n = x.shape[0], x.shape[1]
    x = x - x.mean(axis=1, keepdims=True)
    # FFT autocovariance per chain
    fsize = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, fsize, axis=1)
    acov = np.fft.irfft(f * np.conj(f), fsize, axis=1)[:, :n].real / n
    rho = acov.mean(axis=0) / acov[:, 0].mean()
    # Geyer: sum consecutive pairs while positive and monotone
    tau = 1.0
    prev = np.inf
    for k in range(1, n - 2, 2):
        pair = rho[k] + rho[k + 1]
        if pair < 0:
            break
        pair = min(pair, prev)
        prev = pair
        tau += 2.0 * pair
    return c * n / tau
