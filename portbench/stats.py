"""The benchmark's arithmetic on what a run recorded: percentiles and the
effective sample size."""

import math

import torch


def percentile(values, q):
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks; None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ess_geyer(x, block=16):
    """Effective sample size of each coordinate of ``x`` (chains, draws,
    dims), pooled over chains, by Geyer's initial monotone sequence on the
    FFT autocovariance: ``utils/diagnostics.ess_autocorr`` of the reference
    package, in float64 on ``x``'s device, ``block`` coordinates at a time.
    Returns a (dims,) float64 tensor."""
    c, n, d = x.shape
    fsize = 1 << (2 * n - 1).bit_length()
    out = []
    for j0 in range(0, d, block):
        xs = x[:, :, j0:j0 + block].double().permute(2, 0, 1)  # (b, c, n)
        xs = xs - xs.mean(dim=2, keepdim=True)
        f = torch.fft.rfft(xs, fsize, dim=2)
        acov = torch.fft.irfft(f * f.conj(), fsize, dim=2)[..., :n] / n
        rho = acov.mean(dim=1) / acov[..., 0].mean(dim=1, keepdim=True)
        # pairs rho[k] + rho[k+1] for k = 1, 3, 5, ... < n - 2
        k = torch.arange(1, n - 2, 2, device=x.device)
        pairs = rho[:, k] + rho[:, k + 1]
        # the sum stops at the first negative pair; each pair is capped by
        # the ones before it (monotone)
        live = torch.cumprod((pairs >= 0).to(pairs.dtype), dim=1)
        capped = torch.cummin(pairs, dim=1).values
        tau = 1.0 + 2.0 * (live * capped).sum(dim=1)
        out.append(c * n / tau)
    return torch.cat(out)
