"""Inference observability: convergence diagnostics on numpy arrays, the
summaries of an MCMC or SMC run and a JSONL metrics logger (counterpart of
modppl_tpu/utils/diagnostics.py). Tensors are read to the host as numpy
arrays."""

import json
import time

import numpy as np
import torch


def _np(x):
    """``x`` as a numpy array (a tensor is read to the host)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def split_rhat(samples):
    """Split-chain potential scale reduction (Gelman-Rubin, split version).

    samples: array (chains, draws) or (chains, draws, ...), per trailing
    component. Values near 1.0 indicate convergence.
    """
    x = _np(samples)
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
    x = _np(samples).astype(np.float64)
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


def summarize_mcmc(out, param_names=None):
    """Summary dict for an hmc / nuts / mcmc output: per component of each
    address of ``out["samples"]`` ({addr: (chains, draws, ...)}) its mean,
    sd, split R-hat and ESS, and the run's accept rate, divergence count
    and mean step size where ``out`` has them."""
    summary = {}
    for addr, arr in out["samples"].items():
        if param_names is not None and addr not in param_names:
            continue
        a = _np(arr)
        flat = a.reshape(a.shape[0], a.shape[1], -1)
        for d in range(flat.shape[-1]):
            name = addr if flat.shape[-1] == 1 else f"{addr}[{d}]"
            comp = flat[..., d]
            summary[name] = {
                "mean": float(comp.mean()),
                "std": float(comp.std()),
                "r_hat": float(split_rhat(comp)),
                "ess": float(ess_autocorr(comp)),
            }
    if "accept_prob" in out:
        summary["__accept_rate__"] = float(np.mean(_np(out["accept_prob"])))
    if "divergences" in out:
        summary["__num_divergent__"] = int(np.sum(_np(out["divergences"])))
    if "step_size" in out:
        summary["__step_size__"] = _np(out["step_size"]).mean().item()
    return summary


def summarize_smc(out):
    """Summary dict for a particle filter's output: log-ML, min and mean
    ESS, the resample count and the final log-weights' spread."""
    lw = _np(out["log_weights"])
    return {
        "log_ml": float(_np(out["log_ml"])),
        "min_ess": float(np.min(_np(out["ess"]))),
        "mean_ess": float(np.mean(_np(out["ess"]))),
        "num_resampled": int(np.sum(_np(out["resampled"]))),
        "final_log_weight_spread": float(np.max(lw) - np.min(lw)),
    }


class MetricsLogger:
    """Append-only JSONL metrics sink for long inference runs: one line a
    ``log(step, **metrics)``, with the step, the wall time and each metric
    (a tensor or number as a float)."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "a")

    def log(self, step, **metrics):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
