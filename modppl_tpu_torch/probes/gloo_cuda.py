"""Which gloo collectives take CUDA tensors as they are.

    python3 modppl_tpu_torch/probes/gloo_cuda.py        (one GPU, ~20 s)

For each collective the port uses (parallel/collectives.py) on CUDA
tensors, all_gather, all_reduce with MAX and with SUM, isend/irecv and
barrier, starts two ranks on the one card with a gloo group of their own
(a FileStore in a temporary directory), so that an op that aborts its
process leaves the others to be probed, and records whether the call ran
and gave the right values, the error it raised, or the exit code of the
process it killed. The last line is one JSON object ``{op: "ok" |
"wrong" | "<error>"}``; the ops reported "ok" are those
``collectives.GLOO_CUDA_OPS`` may name.
"""

import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist

OPS = ("all_gather", "pmax", "psum", "ppermute", "barrier")


def _try(fn):
    try:
        return "ok" if fn() else "wrong"
    except Exception as e:  # the probe reports what each op does
        return f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def rank_main(rank, workdir, op):
    import datetime

    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * rank

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.equal(torch.cat(parts).cpu(), torch.tensor(
            [0.0, 1, 2, 3, 10, 11, 12, 13]))

    def reduce(op, want):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return torch.equal(y.cpu(), want)

    def ppermute():
        recv = torch.empty_like(x)
        works = [dist.isend(x, 1 - rank), dist.irecv(recv, 1 - rank)]
        for w in works:
            w.wait()
        return torch.equal(recv.cpu(),
                           (x - 10 * rank + 10 * (1 - rank)).cpu())

    def barrier():
        dist.barrier()
        return True

    calls = {"all_gather": all_gather,
             "pmax": lambda: reduce(dist.ReduceOp.MAX,
                                    torch.tensor([10.0, 11, 12, 13])),
             "psum": lambda: reduce(dist.ReduceOp.SUM,
                                    torch.tensor([10.0, 12, 14, 16])),
             "ppermute": ppermute, "barrier": barrier}
    got = _try(calls[op])
    if rank == 0:
        with open(f"{workdir}/probe.json", "w") as f:
            json.dump(got, f)
    dist.destroy_process_group()


def _probe(op):
    """One op's result, from a fresh pair of ranks."""
    with tempfile.TemporaryDirectory() as workdir:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   "--rank", str(r), workdir, op],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                return "hung (both ranks killed after 120 s)"
        if os.path.exists(f"{workdir}/probe.json"):
            with open(f"{workdir}/probe.json") as f:
                return json.load(f)
        tail = " | ".join(outs[0].strip().splitlines()[-2:])[:300]
        return (f"rank exit codes {[p.returncode for p in procs]}: "
                f"{tail}")


def main():
    if not torch.cuda.is_available():
        print("gloo_cuda: no CUDA device", file=sys.stderr)
        return 1
    got = {op: _probe(op) for op in OPS}
    for op in OPS:
        print(f"# gloo {op} on CUDA tensors: {got[op]}")
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        sys.exit(main())
