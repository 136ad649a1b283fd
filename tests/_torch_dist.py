"""Spawned groups of gloo ranks for the port's multi-shard tests.

``run_group(cases, world, workdir, inputs)`` starts ``world`` processes,
one a rank, each running ``python -m tests._torch_dist <cases> <rank>
<world> <workdir>``. The ranks meet through a ``FileStore`` in ``workdir``
(no port to race for), bring up a gloo group
(``parallel/mesh.initialize_runtime``) and run every case of the module
``cases`` in order: ``CASES``, a list of functions ``case(inputs) -> dict
of numpy arrays``, which every rank calls, as a collective program needs.
Rank r writes what its cases return to ``workdir/rank<r>.npz``.
``inputs`` (a dict of numpy arrays, e.g. the reference's draws, made in
the test process) reaches the cases as ``inputs.npz``.

The ranks import neither JAX nor the JAX package (a rank that has them
loaded fails). A group that does not end within ``timeout`` seconds is
killed, every rank, and the test fails; a collective that waits longer
than ``collective_timeout`` raises in its rank.
"""

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def run_group(cases, world, workdir, inputs=None, timeout=420.0,
              collective_timeout=180.0):
    """Run the cases module ``cases`` on ``world`` gloo ranks; returns the
    list of each rank's results (dicts of numpy arrays), rank order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    # a FileStore left by an earlier group would mix the two rendezvous
    (workdir / "store").unlink(missing_ok=True)
    np.savez(workdir / "inputs.npz", **(inputs or {}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               MODPPL_COLLECTIVE_TIMEOUT=str(collective_timeout))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests._torch_dist", cases, str(rank),
         str(world), str(workdir)],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    deadline = time.monotonic() + timeout
    outputs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            outputs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{cases}: the group of {world} ranks did not "
                             f"end within {timeout} s; every rank killed")
    failed = [(r, p.returncode, out) for r, (p, out) in
              enumerate(zip(procs, outputs)) if p.returncode != 0]
    if failed:
        r, rc, out = failed[0]
        raise AssertionError(f"{cases}: rank {r} exited {rc}:\n"
                             f"{out[-4000:]}")
    results = []
    for rank in range(world):
        with np.load(workdir / f"rank{rank}.npz") as data:
            results.append({k: data[k] for k in data.files})
    return results


def main(cases, rank, world, workdir):
    import torch

    from modppl_tpu_torch.parallel.mesh import initialize_runtime

    torch.set_num_threads(1)
    workdir = Path(workdir)
    initialize_runtime(f"file://{workdir / 'store'}", world, rank,
                       backend="gloo",
                       timeout=float(os.environ["MODPPL_COLLECTIVE_TIMEOUT"]))
    with np.load(workdir / "inputs.npz") as data:
        inputs = {k: data[k] for k in data.files}
    module = importlib.import_module(cases)
    out = {}
    for case in module.CASES:
        for k, v in case(inputs).items():
            out[f"{case.__name__}/{k}"] = np.asarray(v)
    loaded = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith(("jax.", "modppl_tpu.")))
    if loaded or "modppl_tpu" in sys.modules:
        raise AssertionError(f"a rank imported the JAX side: {loaded}")
    np.savez(workdir / f"rank{rank}.npz", **out)
    # every rank past its last collective before any closes its links
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
