"""What NUTS's one host read a subtree (``nuts_transition``: is any chain
still building its tree?) saves, at the NUTS leg's width (BASELINE
configs[3]: the hierarchical model, 10^4 chains, max_depth 6, float32).
Not part of the port; run from the repository root on one CUDA device:

    python3 modppl_tpu_torch/probes/nuts_read.py

After one warm-up run, runs ``chip_smoke.make_nuts_leg`` at ``SHORT``
iterations twice with the read and twice without it (the transition's
``_early_stop=False``), alternating, on run key 6. Every run's draws must
equal the first's bitwise. Prints the card's name and power limit, one
line a run (wall ms, ms a transition, leaves a transition) and, last, one
JSON object of them all.
"""

import functools
import importlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
# the package exports the function nuts; the module by its path
nuts = importlib.import_module("modppl_tpu_torch.inference.nuts")

SHORT = dict(num_warmup=10, num_samples=10)
ORDER = (True, False, False, True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = cs.card_line()
    print(card)
    cs.timed_nuts_run("cuda", 5, num_warmup=2, num_samples=2)
    transition = nuts.nuts_transition
    first, runs = None, []
    try:
        for read in ORDER:
            nuts.nuts_transition = functools.partial(transition,
                                                     _early_stop=read)
            out, wall, leaves = cs.timed_nuts_run("cuda", 6, **SHORT)
            if first is None:
                first = out
            for what in ("unconstrained", "logp", "accept_prob",
                         "tree_depth"):
                if not torch.equal(out[what], first[what]):
                    raise AssertionError(f"{what} differs with and without "
                                         "the read")
            n = SHORT["num_warmup"] + SHORT["num_samples"]
            runs.append({"read": read, "wall_ms": wall * 1e3,
                         "ms_a_transition": wall * 1e3 / n,
                         "leaves_a_transition": leaves})
            print(f"read={read}: {wall * 1e3:.3f} ms, "
                  f"{wall * 1e3 / n:.3f} ms a transition, {leaves:.3f} "
                  f"leaves a transition ({card})")
            sys.stdout.flush()
    finally:
        nuts.nuts_transition = transition
    print(json.dumps({"card": card, "config": {**cs.NUTS, **SHORT},
                      "runs": runs}))


if __name__ == "__main__":
    main()
