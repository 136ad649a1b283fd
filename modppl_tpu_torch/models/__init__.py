"""Models, re-expressed with torch ops on batched tensors."""

from modppl_tpu_torch.models.hierarchical import (
    add_or_remove_param_proposal,
    hierarchical_drift_proposal,
    hierarchical_model,
    read_coeffs,
)
from modppl_tpu_torch.models.hmm import (
    HMM,
    HMMParams,
    hmm_forward_alg,
    hmm_forward_log_ml,
    hmm_forward_log_ml_parallel,
)
from modppl_tpu_torch.models.lgssm import (
    LGSSMParams,
    lgssm_scan_kernel,
    lgssm_simulate,
    make_lgssm,
)
from modppl_tpu_torch.models.pointed import DriftProposal, PointedModel
from modppl_tpu_torch.models.simple import (
    Bounds,
    line_model,
    obs_model,
    pointed_2d_drift_proposal,
    pointed_2d_model,
    uniform_2d,
)
from modppl_tpu_torch.models.spiral import spiral_kernel, spiral_model
from modppl_tpu_torch.models.stochvol import (
    SVParams,
    simulate_sv,
    sv_scan_kernel,
)

__all__ = ["Bounds", "DriftProposal", "HMM", "HMMParams", "LGSSMParams",
           "PointedModel", "SVParams", "add_or_remove_param_proposal",
           "hierarchical_drift_proposal", "hierarchical_model",
           "hmm_forward_alg", "hmm_forward_log_ml",
           "hmm_forward_log_ml_parallel", "lgssm_scan_kernel",
           "lgssm_simulate", "line_model", "make_lgssm", "obs_model",
           "pointed_2d_drift_proposal", "pointed_2d_model", "read_coeffs",
           "simulate_sv", "spiral_kernel", "spiral_model", "sv_scan_kernel",
           "uniform_2d"]
