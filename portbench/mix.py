"""The general traffic generator: a mix file's units, with keys drawn from
the seed.

A mix (``traffic/<cell>.json``) lists under ``units`` the sizes of the jobs
it sends (a filter's particles and steps, a run's chains and iterations)
and says how they are sent: ``loop`` is ``open`` (dispatched back to back,
nothing read back between them) or ``closed`` (each job waited for before
the next). Every seed sends the same units, cycled in the file's order,
and job i carries the key ``fold_in(mix(seed), i)``, so a seed fixes
every input and two runs of one seed send the same jobs.
"""

from portbench.reference.keys import MASK, fold_in, mix

LOOPS = ("open", "closed")
#: the correctness check judges one of the first this many jobs
CHECKED_AMONG = 4


def check_mix(spec):
    """Raise ``ValueError`` unless ``spec`` is a mix this generator reads."""
    if spec.get("loop") not in LOOPS:
        raise ValueError(f"mix: loop must be one of {LOOPS}")
    units = spec.get("units")
    if not units or not all(isinstance(u, dict) for u in units):
        raise ValueError("mix: units must be a non-empty list of objects")


def seed_key(seed):
    return mix(seed & MASK)


def jobs(spec, seed):
    """An endless iterator of job dicts: ``index``, ``key`` and the unit's
    sizes, the units cycled in order."""
    check_mix(spec)
    units = spec["units"]
    base = seed_key(seed)
    i = 0
    while True:
        unit = units[i % len(units)]
        yield {"index": i, "key": fold_in(base, i), **unit}
        i += 1


def warm_jobs(spec, seed):
    """One job of each unit size, keyed apart from the window's jobs."""
    check_mix(spec)
    base = fold_in(seed_key(seed), 1 << 41)
    return [{"index": -1 - u, "key": fold_in(base, u), **unit}
            for u, unit in enumerate(spec["units"])]


def checked_index(seed):
    """The job whose outputs the correctness check judges: one of the
    first ``CHECKED_AMONG`` jobs, drawn from the seed."""
    return fold_in(seed_key(seed), 1 << 40) % CHECKED_AMONG
