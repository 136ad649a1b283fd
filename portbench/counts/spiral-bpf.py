"""Operations and bytes of a spiral filter, from its particles N and steps
T alone, so they read the same whatever implements the filter.

The least bytes: the init writes a state (2 float32) and a log-weight;
each later step reads the last log-weights (for the CDF) and the parents'
states, and writes the new states and log-weights (24 bytes a particle);
the log-ML reads the last log-weights once more.

The operations, a particle-step: two normal draws by the inverse normal
CDF (20 each), the state update (2), the observation's cosine and sine
(20 each), its two coordinates (2), its log-density (6), the weight's
exponential (11), the CDF's add (1), the ESS's square (1) and the slot
position (2): 105.

Kernels 1-3 (``stats_cumsum_kernel``, ``positions_cummax_kernel``,
``resample_from_s_kernel``), T - 1 launches each a filter: kernel 1 reads
the log-weights and writes the CDF rows and two totals a block of the
blocked CDF; kernel 2 reads the CDF rows and block offsets and writes the
slot positions S and a maximum a block; kernel 3 reads S and the states
and writes the states and the parents (each input read once, each output
written once).
"""

FLOPS_PER_PARTICLE_STEP = 105
STATE_FLOATS = 2
RESAMPLE_KERNELS = ("stats_cumsum_kernel", "positions_cummax_kernel",
                    "resample_from_s_kernel")


def cdf_blocks(n):
    """The blocked CDF's block count (``sharded_smc._cdf_block``'s rule:
    blocks of at most 1024, at least 64 of them)."""
    return max(n // 1024, 64)


def filter_counts(n, steps):
    c = STATE_FLOATS
    nb = cdf_blocks(n)
    least_bytes = n * (4 * (c + 1) + (steps - 1) * 2 * 4 * (c + 1) + 4)
    resample_bytes = (steps - 1) * (4 * (2 * n + 2 * nb)
                                    + 4 * (2 * n + 2 * nb + 2)
                                    + 4 * n * (2 + 2 * c))
    return {"bytes": least_bytes,
            "flops": FLOPS_PER_PARTICLE_STEP * n * steps,
            "groups": {"resample": {"names": RESAMPLE_KERNELS,
                                    "bytes": resample_bytes, "flops": 0}}}


def counts(cfg, spec):
    """Per unit of the mix, averaged over its set of units."""
    each = [filter_counts(u["particles"], u["steps"]) for u in spec["units"]]
    k = len(each)
    return {"unit": {"bytes": sum(e["bytes"] for e in each) / k,
                     "flops": sum(e["flops"] for e in each) / k},
            "groups": {"resample": {
                "names": RESAMPLE_KERNELS,
                "bytes": sum(e["groups"]["resample"]["bytes"]
                             for e in each) / k,
                "flops": 0}}}
