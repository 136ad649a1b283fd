"""Linear-Gaussian state-space model (counterpart of
modppl_tpu/models/lgssm.py).

    x_1 ~ N(mu0, P0)
    x_t = A x_{t-1} + w_t,   w_t ~ N(0, Q)     (t >= 2)
    y_t = H x_t + v_t,       v_t ~ N(0, R)

Its exact oracle is the Kalman filter. The scan kernel's body runs once on
the particle-batched state (modeling/autobatch.py), whose particle axis
leads: a state of shape (n, D) maps through ``x @ A.T`` where the
reference's per-particle body writes ``A @ x``.
"""

from dataclasses import dataclass

import torch

from modppl_tpu_torch.core.keys import fold_in, generator, split
from modppl_tpu_torch.dists import mvnormal
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.modeling.handlers import entry_device


@dataclass(frozen=True)
class LGSSMParams:
    """Parameters of a linear-Gaussian SSM, as tensors on the device the
    filter runs on."""

    A: torch.Tensor    # (D, D) transition matrix
    Q: torch.Tensor    # (D, D) process-noise covariance
    H: torch.Tensor    # (E, D) observation matrix
    R: torch.Tensor    # (E, E) observation-noise covariance
    mu0: torch.Tensor  # (D,)   initial mean
    P0: torch.Tensor   # (D, D) initial covariance

    @property
    def state_dim(self):
        return self.A.shape[-1]

    @property
    def obs_dim(self):
        return self.H.shape[-2]


def make_lgssm(A, Q, H, R, mu0, P0, device=None):
    """LGSSMParams from arrays or nested lists, in torch's default float
    dtype on ``device``: without one, the first tensor argument's device,
    else the card (raising without one; pass ``device="cpu"``)."""
    args = (A, Q, H, R, mu0, P0)
    if device is None:
        device = next((x.device for x in args if torch.is_tensor(x)), None)
    device = entry_device(device, "make_lgssm")
    return LGSSMParams(*(torch.as_tensor(x, dtype=torch.get_default_dtype(),
                                         device=device) for x in args))


def lgssm_scan_kernel(params):
    """The bootstrap form: a ScanKernel of @gen functions, the latent drawn
    from its transition and the observation ``obs`` constrained."""
    from modppl_tpu_torch.inference.vsmc import ScanKernel

    @gen
    def init(h, _state0):
        x = h.sample(mvnormal, (params.mu0, params.P0), "x")
        h.sample(mvnormal, (x @ params.H.T, params.R), "obs")
        return x

    @gen
    def step(h, t, x_prev):
        x = h.sample(mvnormal, (x_prev @ params.A.T, params.Q), "x")
        h.sample(mvnormal, (x @ params.H.T, params.R), "obs")
        return x

    return ScanKernel(init, step)


def lgssm_simulate(key, params, num_steps):
    """Draw (states (T, D), observations (T, E)) from the model, on the
    parameters' device, with the key structure of the reference (its
    numbers differ: the port's streams are not threefry's)."""
    device = params.A.device
    k0, k_scan = split(key)
    x = mvnormal.sample(generator(k0, device), (params.mu0, params.P0))
    xs = [x]
    for k in split(fold_in(k_scan, 0), num_steps - 1):
        k_x, _k_y = split(k)
        x = mvnormal.sample(generator(k_x, device), (x @ params.A.T, params.Q))
        xs.append(x)
    ys = [mvnormal.sample(generator(k, device), (x @ params.H.T, params.R))
          for k, x in zip(split(fold_in(key, 1), num_steps), xs)]
    return torch.stack(xs), torch.stack(ys)
