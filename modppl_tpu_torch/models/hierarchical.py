"""Hierarchical model: bernoulli-gated linear or quadratic regression
(counterpart of modppl_tpu/models/hierarchical.py), with its two MH
proposals, the trans-dimensional ``add_or_remove_param_proposal`` among
them.

The eager form: the model branches on the sampled gate, so which
addresses exist depends on it, and the branch reads the gate on the host
(one device sync a run on the card). It runs through the eager entry
points (``importance_sampling(..., vectorized=False)``, ``mh``,
``regen_mh``); the static, lane-batched form is
models/hierarchical_static.py. ``xs`` is a list of Python floats, so a
caller names the device.
"""

from modppl_tpu_torch.dists import bernoulli, normal
from modppl_tpu_torch.modeling import gen

NOISE = 0.1


@gen
def linear(h):
    a = h.sample(normal, (0.0, 1.0), "a")
    b = h.sample(normal, (0.0, 1.0), "b")
    return (a, b)


@gen
def quadratic(h):
    a = h.sample(normal, (0.0, 1.0), "a")
    b = h.sample(normal, (0.0, 1.0), "b")
    c = h.sample(normal, (0.0, 1.0), "c")
    return (a, b, c)


@gen
def hierarchical_model(h, xs):
    """The gate ``is_linear``, the coefficients at ``coeffs`` and one
    observation a point at ``(y, i)``."""
    if h.sample(bernoulli, 0.7, "is_linear"):
        a, b = h.trace(linear, (), "coeffs")
        return [h.sample(normal, (a + b * x, NOISE), f"(y, {i})")
                for i, x in enumerate(xs)]
    a, b, c = h.trace(quadratic, (), "coeffs")
    return [h.sample(normal, (a + b * x + c * x * x, NOISE), f"(y, {i})")
            for i, x in enumerate(xs)]


@gen
def add_or_remove_param_proposal(h, trace):
    """The trans-dimensional jump: drift a and b, redraw the gate, and in
    the quadratic branch drift c (from 0 where the trace has none)."""
    h.sample(normal, (trace.data.read("coeffs/a"), 0.025), "coeffs/a")
    h.sample(normal, (trace.data.read("coeffs/b"), 0.025), "coeffs/b")
    if not h.sample(bernoulli, 0.5, "is_linear"):
        if trace.data.search("coeffs/c") is not None:
            prev_c = trace.data.read("coeffs/c")
        else:
            prev_c = 0.0
        h.sample(normal, (prev_c, 0.025), "coeffs/c")


@gen
def hierarchical_drift_proposal(h, trace, drift_std):
    """Within-model drift of the trace's coefficients."""
    h.sample(normal, (trace.data.read("coeffs/a"), drift_std), "coeffs/a")
    h.sample(normal, (trace.data.read("coeffs/b"), drift_std), "coeffs/b")
    if not trace.data.read("is_linear"):
        h.sample(normal, (trace.data.read("coeffs/c"), drift_std), "coeffs/c")


def read_coeffs(trace):
    """[a, b] or [a, b, c] of a trace."""
    a = trace.data.read("coeffs / a")
    b = trace.data.read("coeffs / b")
    if not trace.data.read("is_linear"):
        return [a, b, trace.data.read("coeffs / c")]
    return [a, b]
