"""Functional Adam over a tuple of tensors: optax.adam's update, formula
for formula and in optax's order, so a trajectory agrees with the
reference's to rounding.

``torch.optim.Adam`` is not used: it keeps one state per parameter object
(it cannot batch a leading restart axis as one ``vmap`` of optax does) and
orders its arithmetic differently (it folds the bias corrections into the
step size). Any leading axis of a tensor here is simply elementwise.
"""

import numpy as np
import torch


def adam_init(params):
    """State for ``params`` (a tuple of tensors): the step count, on the
    host, and zero first and second moments."""
    zeros = tuple(torch.zeros_like(p) for p in params)
    return {"count": 0, "mu": zeros, "nu": zeros}


def adam_step(params, grads, state, learning_rate, b1=0.9, b2=0.999,
              eps=1e-8):
    """One step of ``optax.adam(learning_rate)`` followed by
    ``optax.apply_updates``: returns (new params, new state).

    ``learning_rate`` is a number or a schedule, a function of the step
    count before this step (0 first) returning a number, as optax calls
    it. ``grads`` are the gradients of the loss being minimized.
    """
    count = state["count"] + 1
    mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state["mu"]))
    nu = tuple((1 - b2) * (g * g) + b2 * v
               for g, v in zip(grads, state["nu"]))
    bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
    lr = (learning_rate(state["count"]) if callable(learning_rate)
          else learning_rate)
    new = tuple(p + -lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps))
                for p, m, v in zip(params, mu, nu))
    return new, {"count": count, "mu": mu, "nu": nu}


def exponential_decay(init_value, transition_steps, decay_rate):
    """``optax.exponential_decay(init_value, transition_steps,
    decay_rate)`` (no staircase, no delay): init_value * decay_rate **
    (count / transition_steps) in float32, as optax computes it (its step
    count is int32, so the exponent is float32 and so is the power): numpy
    float32 scalars, whose power and product agree with optax's value
    bitwise."""
    def schedule(count):
        if count <= 0:
            return float(np.float32(init_value))
        p = np.float32(count) / np.float32(transition_steps)
        return float(np.float32(init_value * decay_rate ** p))

    return schedule
