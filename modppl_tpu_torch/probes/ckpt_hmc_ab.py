"""Phase 34 of ``chip_smoke.py`` (the checkpointed HMC runner on the
conjugate model, 10^4 chains, 100 warmup + 200 samples, L = 8) in two
checkouts of the repository, in turns A, B, B, A, each in a fresh process
on one CUDA device. Not part of the port; run from the repository root:

    python3 modppl_tpu_torch/probes/ckpt_hmc_ab.py A_DIR B_DIR [--profile]

Each turn runs ``chip_smoke.check_ckpt_hmc`` of its checkout (its gates
included) and prints one line: the checkout, the uninterrupted run's wall
seconds, mean, sd, r_hat, ESS, accept rate and step size. ``--profile``
adds, in B's first turn, chip_smoke's profile of the runner at 10 + 20.
Prints the card's name and power limit first and, last, one JSON object
of the turns.
"""

import json
import subprocess
import sys
from pathlib import Path

TURN = """
import json, sys, tempfile
sys.path.insert(0, {root!r})
import chip_smoke as cs
seen = cs.check_ckpt_hmc("cuda")
if {profile}:
    with tempfile.TemporaryDirectory() as tmp:
        run = cs.make_ckpt_hmc("cuda", tmp + "/p", cs.CKPT_HMC_PROFILED)
        med, _ = cs.time_runs(lambda i: run(20 + i), 3, "cuda")
        cs.profile_run("checkpointed HMC runner (10 + 20)", lambda: run(99),
                       med)
print(json.dumps(seen))
"""


def turn(root, profile):
    out = subprocess.run([sys.executable, "-c",
                          TURN.format(root=str(root), profile=profile)],
                         cwd=root, capture_output=True, text=True, check=True)
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    return json.loads(lines[-1])


def main(argv):
    a, b = (Path(p).resolve() for p in argv[1:3])
    profile = "--profile" in argv
    sys.path.insert(0, str(b))
    import chip_smoke as cs

    print(cs.card_line())
    turns = []
    for name, root, prof in (("A", a, False), ("B", b, profile),
                             ("B", b, False), ("A", a, False)):
        seen = turn(root, prof)
        print(f"{name} {root}: wall {seen['wall_s']!r} s, mean "
              f"{seen['mean']!r}, sd {seen['std']!r}, r_hat "
              f"{seen['r_hat']!r}, ESS {seen['ess']!r}, accept "
              f"{seen['accept']!r}, eps {seen['eps']!r}")
        turns.append({"tree": name, **seen})
        sys.stdout.flush()
    print(json.dumps({"turns": turns}))


if __name__ == "__main__":
    main(sys.argv)
