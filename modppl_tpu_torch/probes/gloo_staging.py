"""Gloo's own CUDA path against explicit host staging, for the sharded
filter on ranks that share one card.

    python3 modppl_tpu_torch/probes/gloo_staging.py     (one GPU, ~5 min)

``parallel/collectives.GLOO_CUDA_OPS`` names the gloo ops that take CUDA
tensors as they are (all_gather, all_reduce); the others stage through
the host. This probe runs the main path's spiral filter (2^20 x 10, key
101 on) at dp = 2 and dp = 4 on four gloo ranks sharing the card, in
turns: staged (every op copied to the host and back by the collectives
module), native (the ops of ``GLOO_CUDA_OPS`` handed to gloo as CUDA
tensors), native, staged; each turn a fresh group, each dp one warm-up
and five timed filters on rank 0's clock, every rank starting together.
It checks that both ways give the same outputs bitwise (a digest). The
last line is one JSON object of every turn's times.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORLD = 4
RUNS = 5


def rank_main(rank, workdir, mode):
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from modppl_tpu_torch.parallel import collectives
    from modppl_tpu_torch.parallel.mesh import initialize_runtime, make_mesh

    initialize_runtime(f"file://{workdir}/store", WORLD, rank,
                       backend="gloo", timeout=300.0)
    if mode == "staged":
        collectives.GLOO_CUDA_OPS = frozenset()
    meshes = {2: make_mesh(dp=2, ranks=[0, 1]), WORLD: make_mesh(dp=WORLD)}
    seen = {}
    for dp, mesh in meshes.items():
        if not mesh.member:
            continue
        collectives.reset_counts()
        out = cs.whole_outputs(mesh, cs.run_filter("cuda", cs.N, 7,
                                                   mesh=mesh))
        copies = collectives.counts()["host_copies"]
        ms = cs.timed_sharded(lambda i: cs.run_filter(
            "cuda", cs.N, 101 + i, mesh=mesh, store_ancestry=False), mesh,
            "cuda", runs=RUNS)
        seen[f"dp{dp}"] = {"ms": ms, "median_ms": statistics.median(ms),
                           "host_copies": copies,
                           "digest": cs.digest(out["state"])}
    if rank == 0:
        with open(f"{workdir}/turn.json", "w") as f:
            json.dump(seen, f)
    import torch

    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def turn(mode):
    with tempfile.TemporaryDirectory() as workdir:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             workdir, mode], cwd=REPO) for r in range(WORLD)]
        for p in procs:
            try:
                p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise RuntimeError(f"turn {mode}: the ranks did not end")
        if any(p.returncode for p in procs):
            raise RuntimeError(f"turn {mode}: ranks exited "
                               f"{[p.returncode for p in procs]}")
        with open(f"{workdir}/turn.json") as f:
            return json.load(f)


def main():
    import torch

    if not torch.cuda.is_available():
        print("gloo_staging: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from modppl_tpu_torch.ops import _build

    _build.build()
    print(f"# card: {cs.card_line()}")
    rows = []
    for mode in ("staged", "native", "native", "staged"):
        got = turn(mode)
        rows.append({"turn": mode, **got})
        print(f"# {mode}: " + "; ".join(
            f"{dp} median {v['median_ms']:.3f} ms of "
            f"{[round(t, 3) for t in v['ms']]}, host copies "
            f"{v['host_copies']}" for dp, v in got.items()))
        sys.stdout.flush()
    digests = {(dp, r[dp]["digest"]) for r in rows for dp in ("dp2", "dp4")}
    if len(digests) != 2:
        raise AssertionError(f"staged and native outputs differ: {digests}")
    print("# staged and native outputs bitwise equal at dp = 2 and 4")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        sys.exit(main())
