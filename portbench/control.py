"""The correctness check's control: the plain reference put in the
program's place, computed in the precision below the configuration's,
and judged by the same numbers a run compares. Its readings are the upper
ends the limits in ``reference/<config>.limits.json`` are set below.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--units k]

prints one JSON line a seed: the control's numbers beside the limits, and
whether the check would pass it (it must not). Each reference module
gives its control as ``control_numbers(cfg, spec, job, seed, device,
units)``, run here on the job a run with that seed checks; ``--units``
is the size of the control's window where it has one (a filter
reference's count of filters).
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def control_numbers(workload, seed, units=None, device="cuda",
                    overrides=None):
    """{number: (the control's reading, limit)} for ``workload`` at its
    sizes (or those ``overrides`` sets, as in ``run.run_cell``)."""
    from portbench import loader, mix as mixes

    w = loader.workload(loader.benchmark(), workload)
    cfg = loader.read_json(loader.HERE / "configs" / f"{w['config']}.json")
    spec = loader.traffic(workload)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        spec = {**spec, **overrides.get("traffic", {})}
    ref, limits = loader.reference(w["config"])
    job = next(j for j in mixes.jobs(spec, seed)
               if j["index"] == mixes.checked_index(seed))
    kw = {} if units is None else {"units": units}
    numbers = ref.control_numbers(cfg, spec, job, seed, device, **kw)
    return {k: (v, limits[k]) for k, v in numbers.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=None)
    args = p.parse_args(argv)
    for seed in args.seeds:
        nums = control_numbers(args.workload, seed, args.units)
        passes = all(v <= lim for v, lim in nums.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "passes": passes,
                          "numbers": {k: {"value": v, "limit": lim}
                                      for k, (v, lim) in nums.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
