"""Operations and bytes of a pooled-adaptation HMC run on a quadratic
target, from its chains C, dimension d, leapfrog steps L and iterations.

The operations, a transition of a chain: L + 1 gradients b - u Lambda of
2 d^2 each, the log-density at both ends from the gradient (4 d), and 7 d
a leapfrog step (two momentum and one position multiply-add, the
gradient's subtraction). The bytes, a phase of ``num`` transitions: Lambda,
b and the inverse mass, the chains' start positions, the pre-drawn
momenta, jitters and accept uniforms (num C (d + 2) floats), and its
outputs: the warmup's end positions, step size and inverse mass; the
sampling's positions, log-densities, accept probabilities and divergence
flags a transition (num C (4 d + 9) bytes). Kernels 6 and 7
(``warmup_kernel``, ``sample_kernel``) do all of it.
"""

CHUNK_KERNELS = ("warmup_kernel", "sample_kernel")


def run_counts(d, c, L, warmup, samples):
    per = (L + 1) * 2 * d * d + 4 * d + 7 * d * L
    q = 4 * (d * d + 2 * d)
    flops = (warmup + samples) * c * per
    nbytes = 0
    for phase, num in (("warmup", warmup), ("sample", samples)):
        streams = 4 * num * c * (d + 2)
        if phase == "warmup":
            nbytes += q + 4 * c * d + streams + 4 * c * d + 4 * (d + 1)
        else:
            nbytes += q + 4 * c * d + streams + num * c * (4 * d + 9)
    return {"bytes": nbytes, "flops": flops}


def counts(cfg, spec):
    each = [run_counts(cfg["dim"], u["chains"], cfg["num_leapfrog"],
                       u["warmup"], u["samples"]) for u in spec["units"]]
    k = len(each)
    unit = {key: sum(e[key] for e in each) / k for key in ("bytes", "flops")}
    return {"unit": unit,
            "groups": {"chunk": {"names": CHUNK_KERNELS, **unit}}}
