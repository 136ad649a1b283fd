"""What kernels 3 and 4 (``resample_fused_from_s``, ``grid_rank``;
csrc/fused_resample.cu, csrc/grid_rank.cu, their rank step in
csrc/rank.cuh) could reach, and how the merge path's tile moves them, at
the main paths' shapes: N = 2^20, kernel 3 on the filter's (N, 2) state.
Not part of the port; run from the repository root on one CUDA device:

    python3 modppl_tpu_torch/csrc/probes/rank_cost.py

1. Builds ``rank_cost.cu`` (which includes ``../grid_rank.cu`` and
   ``../fused_resample.cu``) once for each tile in ``THREADS`` x ``ITEMS``
   (``-DMODPPL_RANK_THREADS``, ``-DMODPPL_RANK_ITEMS``), one nvcc each, all
   at once, into ``modppl_tpu_torch/_build/probes/``.
2. For each build: kernel 4 on uniform and degenerate S and kernel 3
   (uniform, C = 2, layout "nc"): ms with L2 flushed before each launch
   (``chip_smoke.time_ms``) and the profiler's us a launch over
   back-to-back launches, L2 warm as on the filters' paths. Each build's
   outputs must equal the kernel library's, bitwise.
3. From the build with the library's tile: the floors (an empty kernel with
   the rank step's grid; a coalesced 16-byte copy of the bytes each kernel
   must move), design alternative (a) (per-slot search below 2^11 cuts of
   S staged in shared memory), alternative (b) (one thread a particle
   writing its slot range) and the replaced design (one thread a slot, a
   binary search over all of S), each checked bitwise against the library;
   the merge path with a per-thread walk in place of the run marks and
   scan (``walk_rank_kernel``); kernel 3 with each thread copying its own
   group of rows from registers (``group_copy_kernel``); and kernel 4 cut after each phase of its
   rank step (``phase_kernel``: the marks zeroed and the two warp
   searches; + the window's run marks and the stores), beside the whole
   kernel.

Prints one line per measurement and, last, one JSON object of them all.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402
from modppl_tpu_torch.ops import _build  # noqa: E402
from modppl_tpu_torch.ops import fused_resample as fr  # noqa: E402
from modppl_tpu_torch.ops import resample as rs  # noqa: E402
from modppl_tpu_torch.utils.numerics import (  # noqa: E402
    logsumexp,
    normalized_cdf,
)
from small_cost import back_to_back_us, entry, profiled_us  # noqa: E402

THREADS = (128, 256)
ITEMS = (4, 8, 16)
N = 1 << 20
C = 2
LAUNCHES = 200
SOURCE = HERE / "rank_cost.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_RANK_ARGS = (_P, _I, _I, _I, _P, _P)
_COPY_ARGS = (_P, _P, _L, _P, _P, _L, _P)
_LEGACY3_ARGS = (_P, _P, _P, _P, _I, _I, _P)


def build_all():
    """{(threads, items): ctypes library}, built all at once."""
    out_dir = _build.BUILD / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for threads in THREADS:
        for items in ITEMS:
            lib = out_dir / f"rank_cost_t{threads}_k{items}.so"
            jobs[threads, items] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                 f"-DMODPPL_RANK_THREADS={threads}",
                 f"-DMODPPL_RANK_ITEMS={items}", "-o", str(lib),
                 str(SOURCE)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} {key}:\n{log}")
        name = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1][-48:]
            elif "registers" in line or "spill" in line:
                print(f"#   {key} {name}: {line.split(':', 1)[-1].strip()}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def s_of(kind):
    """S at N for ``kind`` weights, as the filters compute it."""
    lw = cs.make_lw(kind, N, 0, "cuda")
    return rs.slot_positions(normalized_cdf(lw - logsumexp(lw)),
                             torch.tensor(0.37, device="cuda"), N)


def timed(fn, symbol):
    """(ms with L2 flushed, profiled us a launch back to back, back-to-back
    us a launch by CUDA events)."""
    return (cs.time_ms(fn), profiled_us(fn, symbol, LAUNCHES),
            back_to_back_us(fn, LAUNCHES))


def require_equal(what, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: differs from the kernel library")


def main():
    card = cs.card_line()
    print(f"# {card}")
    _build.build()
    libs = build_all()
    s = {kind: s_of(kind) for kind in ("uniform", "degenerate")}
    state = torch.randn(N, C, device="cuda")
    want4 = {kind: rs.grid_rank(x, N) for kind, x in s.items()}
    want3 = fr.resample_fused_from_s(s["uniform"], state, layout="nc")
    parents = torch.empty(N, dtype=torch.int32, device="cuda")
    out = torch.empty_like(state)
    result = {"card": card, "n": N, "c": C, "builds": []}

    for (threads, items), lib in libs.items():
        k4 = entry(lib, "modppl_grid_rank_i32", rs._ARGS)
        k3 = entry(lib, "modppl_resample_from_s_f32", fr._ARGS)
        row = {"threads": threads, "items": items}
        for kind, x in s.items():
            run = (lambda x=x: k4(x.data_ptr(), N, N, N, parents.data_ptr()))
            run()
            torch.cuda.synchronize()
            require_equal(f"grid_rank {threads}x{items} {kind}", parents,
                          want4[kind])
            row[f"grid_rank_{kind}"] = timed(run, "grid_rank_kernel")
        x = s["uniform"]
        run = (lambda: k3(x.data_ptr(), state.data_ptr(), out.data_ptr(),
                          parents.data_ptr(), N, C, 1))
        run()
        torch.cuda.synchronize()
        require_equal(f"kernel 3 {threads}x{items} parents", parents,
                      want3[1])
        require_equal(f"kernel 3 {threads}x{items} states", out, want3[0])
        row["resample_fused"] = timed(run, "resample_from_s_kernel")
        result["builds"].append(row)
        print(f"tile {threads} x {items}: grid_rank uniform "
              f"{row['grid_rank_uniform']}, degenerate "
              f"{row['grid_rank_degenerate']}; kernel 3 "
              f"{row['resample_fused']} (ms L2 cold, us profiled, us back "
              f"to back)")
        sys.stdout.flush()

    lib = libs[rs.RANK_THREADS, rs.RANK_ITEMS]
    x = s["uniform"]
    empty = entry(lib, "probe_empty_rank", _RANK_ARGS)
    copy = entry(lib, "probe_copy", _COPY_ARGS)
    dst_s = torch.empty_like(x)
    dst_state = torch.empty_like(state)
    floors = {
        "empty_rank_grid": timed(
            lambda: empty(x.data_ptr(), N, N, N, parents.data_ptr()),
            "empty_rank_kernel"),
        "copy_grid_rank_bytes": timed(
            lambda: copy(x.data_ptr(), dst_s.data_ptr(), N // 4, 0, 0, 0),
            "copy_kernel"),
        "copy_kernel3_bytes": timed(
            lambda: copy(x.data_ptr(), dst_s.data_ptr(), N // 4,
                         state.data_ptr(), dst_state.data_ptr(), N * C // 4),
            "copy_kernel"),
    }
    if not (torch.equal(dst_s, x) and torch.equal(dst_state, state)):
        raise AssertionError("probe_copy: the copy differs from its source")
    result["floors"] = floors
    print(f"floors: {floors}")

    alts = {}
    for name, symbol in (("probe_walk_rank", "walk_rank_kernel"),
                         ("probe_tree_rank", "tree_rank_kernel"),
                         ("probe_scatter_rank", "scatter_rank_kernel"),
                         ("probe_legacy_rank", "legacy_rank_kernel")):
        fn = entry(lib, name, _RANK_ARGS)
        for kind, sk in s.items():
            run = (lambda fn=fn, sk=sk: fn(sk.data_ptr(), N, N, N,
                                           parents.data_ptr()))
            run()
            torch.cuda.synchronize()
            require_equal(f"{name} {kind}", parents, want4[kind])
            alts[f"{name}_{kind}"] = timed(run, symbol)
    for name, symbol in (("probe_group_copy", "group_copy_kernel"),
                         ("probe_legacy_resample", "legacy_resample_kernel")):
        fn = entry(lib, name, _LEGACY3_ARGS)
        run = (lambda fn=fn: fn(x.data_ptr(), state.data_ptr(),
                                out.data_ptr(), parents.data_ptr(), N, C))
        run()
        torch.cuda.synchronize()
        require_equal(f"{name} parents", parents, want3[1])
        require_equal(f"{name} states", out, want3[0])
        alts[f"{name}_uniform"] = timed(run, symbol)
    result["alternatives"] = alts
    phase = entry(lib, "probe_phase", (_I,) + _RANK_ARGS)
    phases = {}
    for kind, sk in s.items():
        for p in (1, 2):
            phases[f"phase{p}_{kind}"] = timed(
                lambda p=p, sk=sk: phase(p, sk.data_ptr(), N, N, N,
                                         parents.data_ptr()),
                f"phase_kernel<{p}>")
    result["phases"] = phases
    for k, v in phases.items():
        print(f"{k}: {v}")
    for k, v in alts.items():
        print(f"{k}: {v}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
