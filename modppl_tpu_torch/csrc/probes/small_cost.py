"""What kernels 8 and 9 (``hmc_transition_small``, ``hmc_sample_chunk_small``,
csrc/hmc_small.cu) could reach, and how their launch shape moves them, at
the hierarchical leg's shapes: kernel 9 over its sampling phase (10^4
chains, d = 3, 500 transitions, L = 8), kernel 8 at (10^4, 3), L = 8. Not
part of the port; run from the repository root on one CUDA device:

    python3 modppl_tpu_torch/csrc/probes/small_cost.py

1. Builds ``small_cost.cu`` (which includes ``../hmc_small.cu``) once for
   each (chains a block, ring depth) in ``BLOCKS`` x ``STAGES``, one nvcc
   each, all at once, into ``modppl_tpu_torch/_build/probes/``; kernel 8
   takes the same chains a block.
2. For each build: kernel 9's ms (CUDA events, L2 flushed before each
   launch: ``chip_smoke.time_ms``), kernel 8's ms the same way and its us a
   launch over 500 back-to-back launches through ctypes (as
   ``hmc_quadratic`` makes them; CUDA events, and the profiler's device
   us a launch), and the dependent-chain
   floor (``chain_floor_kernel``: kernel 9's loop with its streams read
   from one fixed slot, no DRAM). Each build's outputs must equal the
   kernel library's, bitwise.
3. The launch floor, from the library's own block sizes: an empty kernel
   with kernel 8's grid, block and arguments, 500 back-to-back launches
   (CUDA events) and the profiler's us a launch, beside kernel 8's own.

Prints one line per measurement and, last, one JSON object of them all.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from modppl_tpu_torch.ops import _build  # noqa: E402
from modppl_tpu_torch.ops import leapfrog_small as lfs  # noqa: E402

BLOCKS = (32, 64, 128)
STAGES = (2, 4, 8)
LAUNCHES = 500
SOURCE = Path(__file__).with_name("small_cost.cu")


def build_all():
    """{(block, stages): ctypes library}, built all at once."""
    out_dir = _build.BUILD / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for block in BLOCKS:
        for stages in STAGES:
            lib = out_dir / f"small_cost_b{block}_s{stages}.so"
            jobs[block, stages] = (lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                 f"-DMODPPL_SAMPLE_BLOCK={block}",
                 f"-DMODPPL_SAMPLE_STAGES={stages}",
                 f"-DMODPPL_TRANSITION_BLOCK={block}", "-o", str(lib),
                 str(SOURCE)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} {key}:\n{log}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def entry(lib, name, argtypes):
    """``name`` in ``lib`` as a function of its arguments but the stream
    (the last of ``argtypes``), launched on the current stream."""
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int

    def call(*args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return call


def back_to_back_us(fn, count=LAUNCHES):
    """us a launch over ``count`` launches queued back to back (CUDA
    events around them all)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / count


def profiled_us(fn, symbol, count=LAUNCHES):
    """The profiler's device us a launch of kernel ``symbol`` over
    ``count`` back-to-back launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(count):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and symbol in e.key
            and e.device_time_total > 0]
    if not hits:
        return None
    return (sum(e.device_time_total for e in hits)
            / sum(e.count for e in hits))


def ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def main():
    card = cs.card_line()
    print(f"# {card}")
    _build.build()
    libs = build_all()
    _, samp = cs.leg_inputs("hierarchical")
    u0, mom, epsj, u01, lam, b, im, steps = samp
    num, n, d = mom.shape
    us = torch.empty(num, n, d, device="cuda")
    lps, aps = torch.empty(num, n, device="cuda"), torch.empty(num, n,
                                                               device="cuda")
    dvs = torch.empty(num, n, dtype=torch.bool, device="cuda")
    sample_args = (*ptrs(u0, mom, epsj, u01, lam, b, im), n, d, num, steps,
                   *ptrs(us, lps, aps, dvs))
    want9 = lfs.sample_chunk_small(*samp)

    tu, tp, teps, tu01 = u0, mom[0], epsj[0], u01[0]
    t_out = [torch.empty(n, d, device="cuda") for _ in range(2)]
    t_out += [torch.empty(n, device="cuda") for _ in range(4)]
    tdv = torch.empty(n, dtype=torch.bool, device="cuda")
    u_o, p_o, tlp, tap, th0, th1 = t_out
    trans_args = (*ptrs(tu, tp, teps, tu01, lam, b, im), n, d, steps,
                  *ptrs(u_o, p_o, tlp, tap, tdv, th0, th1))
    want8 = lfs.hmc_transition_small(tu, tp, teps, tu01, lam, b, im, steps)
    want8 = (*want8[0], *want8[1:])

    result = {"card": card, "builds": []}
    for (block, stages), lib in libs.items():
        k9 = entry(lib, "modppl_hmc_sample_small_f32", lfs._SAMPLE_ARGS)
        k8 = entry(lib, "modppl_hmc_transition_small_f32",
                   lfs._TRANSITION_ARGS)
        floor = entry(lib, "probe_chain_floor", lfs._SAMPLE_ARGS)
        run9 = lambda: k9(*sample_args)  # noqa: E731
        run8 = lambda: k8(*trans_args)  # noqa: E731
        run9()
        run8()
        torch.cuda.synchronize()
        same = (all(torch.equal(x, y) for x, y in
                    zip((us, lps, aps, dvs), want9))
                and all(torch.equal(x, y) for x, y in
                        zip((u_o, p_o, tlp, tap, tdv, th0, th1), want8)))
        if not same:
            raise AssertionError(f"build {block}, {stages}: outputs differ "
                                 f"from the kernel library's")
        row = {"block": block, "stages": stages,
               "sample_ms": cs.time_ms(run9, reps=5, warmup=1),
               "transition_ms": cs.time_ms(run8),
               "transition_back_to_back_us": back_to_back_us(run8),
               "transition_profiled_us": profiled_us(
                   run8, "transition_small_kernel"),
               "chain_floor_ms": cs.time_ms(lambda: floor(*sample_args),
                                            reps=5, warmup=1)}
        result["builds"].append(row)
        print(f"block {block} stages {stages}: kernel 9 "
              f"{row['sample_ms']:.4f} ms, chain floor "
              f"{row['chain_floor_ms']:.4f} ms; kernel 8 "
              f"{row['transition_ms']:.4f} ms, back to back "
              f"{row['transition_back_to_back_us']:.3f} us a launch, "
              f"{row['transition_profiled_us']} us by the profiler")
        sys.stdout.flush()

    lib = libs[lfs.TRANSITION_BLOCK, lfs.SAMPLE_STAGES]
    empty = entry(lib, "probe_empty_transition", lfs._TRANSITION_ARGS)
    k8 = entry(lib, "modppl_hmc_transition_small_f32", lfs._TRANSITION_ARGS)
    launch = {
        "empty_back_to_back_us": back_to_back_us(lambda: empty(*trans_args)),
        "empty_profiled_us": profiled_us(lambda: empty(*trans_args),
                                         "empty_transition_kernel"),
        "transition_back_to_back_us": back_to_back_us(
            lambda: k8(*trans_args)),
        "transition_profiled_us": profiled_us(lambda: k8(*trans_args),
                                              "transition_small_kernel"),
    }
    result["launch_floor"] = launch
    print(f"launch floor (kernel 8's grid of {lfs.TRANSITION_BLOCK}-thread "
          f"blocks, {LAUNCHES} launches): empty kernel "
          f"{launch['empty_back_to_back_us']:.3f} us a launch back to back, "
          f"{launch['empty_profiled_us']} us by the profiler; kernel 8 "
          f"{launch['transition_back_to_back_us']:.3f} us back to back, "
          f"{launch['transition_profiled_us']} us by the profiler")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
