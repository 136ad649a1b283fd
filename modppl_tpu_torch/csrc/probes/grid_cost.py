"""What kernels 1 and 2 (``stats_cumsum``, ``positions_cummax``;
csrc/grid_positions.cu) could reach, and how the warps a CTA and the layout
move them, at the spiral filter's shapes: N = 2^20, 1024 rows of 1024. Not
part of the port; run from the repository root on one CUDA device:

    python3 modppl_tpu_torch/csrc/probes/grid_cost.py

1. Builds ``grid_cost.cu`` (which includes ``../grid_positions.cu``) once
   for each count in ``WARPS`` (``-DMODPPL_GRID_WARPS``), one nvcc each, all
   at once, into ``modppl_tpu_torch/_build/probes/``.
2. For each build: both kernels, each timed three ways: ms with L2 flushed
   before each launch (``chip_smoke.time_ms``), the profiler's us a launch
   over back-to-back launches with L2 warm, as on the filter's path, and us
   a launch back to back by CUDA events. Each build's outputs must equal the
   kernel library's, bitwise.
3. From the build with the library's warps a CTA: the floors (an empty
   kernel with the kernels' grid; a coalesced 16-byte copy of the 8 MB each
   kernel moves), kernel 1 in the contiguous layout (``contig_stats_kernel``)
   and with a second full scan for sum(e^2) (``twoscan_stats_kernel``),
   kernel 2 in the strided layout (``strided_positions_kernel``) and with
   32 contiguous elements a lane (``contig_positions_kernel``), and the
   replaced design of both (``legacy_*_kernel``), each checked bitwise
   against the library; both kernels cut after each phase
   (``stats_phase_kernel``, ``positions_phase_kernel``); and the count of
   SASS instructions by opcode of each kernel at bw = 1024
   (``cuobjdump -sass``).

Prints one line per measurement and, last, one JSON object of them all.
"""

import collections
import ctypes
import json
import re
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
from modppl_tpu_torch.ops import grid_positions as gp  # noqa: E402
from small_cost import back_to_back_us, entry, profiled_us  # noqa: E402

WARPS = (1, 2, 4, 8)
N = 1 << 20
LAUNCHES = 200
SOURCE = HERE / "grid_cost.cu"

_P, _L = ctypes.c_void_p, ctypes.c_longlong
_COPY_ARGS = (_P, _P, _L, _P)
# the kernels whose SASS is counted, by a piece of their mangled names
SASS_KERNELS = {"stats_cumsum": "stats_cumsum_kernelILi32ELi32E",
                "positions_cummax": "positions_cummax_kernelILi32ELi32ELb1E",
                "legacy_stats": "legacy_stats_kernel",
                "legacy_positions": "legacy_positions_kernel"}


def build_all():
    """{warps a CTA: ctypes library}, built all at once."""
    out_dir = _build.BUILD / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for warps in WARPS:
        lib = out_dir / f"grid_cost_w{warps}.so"
        jobs[warps] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             f"-DMODPPL_GRID_WARPS={warps}", "-o", str(lib), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for warps, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} w{warps}:\n"
                               f"{log}")
        name = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif ("registers" in line or "spill" in line) and (
                    "Li32ELi32E" in name or not any(
                        k in name for k in ("cumsum_k", "cummax_k"))):
                # the library's kernels at bw = 1024, and the probe's own
                print(f"#   w{warps} {name[-56:]}: "
                      f"{line.split(':', 1)[-1].strip()}")
        libs[warps] = ctypes.CDLL(str(lib))
    return libs


def sass_counts(lib):
    """{kernel: {opcode: count}} of SASS_KERNELS in the library ``lib``
    (cuobjdump -sass; an opcode without its predicate and modifiers), with
    each kernel's total under "all"."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    counts, current = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            current = next((k for k, v in SASS_KERNELS.items() if v in line),
                           None)
            if current:
                counts[current] = collections.Counter()
        elif current:
            found = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9]*)", line)
            if found:
                counts[current][found.group(2)] += 1
                counts[current]["all"] += 1
    return {k: dict(v.most_common()) for k, v in counts.items()}


def timed(fn, symbol):
    """(ms with L2 flushed, profiled us a launch back to back, back-to-back
    us a launch by CUDA events)."""
    return (cs.time_ms(fn), profiled_us(fn, symbol, LAUNCHES),
            back_to_back_us(fn, LAUNCHES))


def require_equal(what, got, want):
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: differs from the kernel library")


def main():
    card = cs.card_line()
    print(f"# {card}")
    _build.build()
    libs = build_all()
    lw = cs.make_lw("uniform", N, 0, "cuda")
    rows, m = lw.reshape(-1, 1024), lw.max()
    nb, bw = rows.shape
    cum, totals, _ = gp.stats_cumsum_plain(rows, m)
    offs_incl = gp.doubling_cumsum(totals[None, :])[0]
    offs = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
    total = offs_incl[-1]
    u = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    want1 = gp.stats_cumsum(rows, m)
    want2 = gp.positions_cummax(cum, offs, total, u, N)
    out1 = (torch.empty_like(rows), torch.empty(nb, device="cuda"),
            torch.empty(nb, device="cuda"))
    out2 = (torch.empty(nb, bw, dtype=torch.int32, device="cuda"),
            torch.empty(nb, dtype=torch.int32, device="cuda"))
    args1 = (rows.data_ptr(), m.data_ptr(), *[t.data_ptr() for t in out1],
             nb, bw)
    args2 = (cum.data_ptr(), offs.data_ptr(), total.data_ptr(), u.data_ptr(),
             *[t.data_ptr() for t in out2], nb, bw, N)
    result = {"card": card, "n": N, "bw": bw, "builds": []}

    def held(what, fn, symbol, out, want):
        for t in out:  # nothing a launch leaves unwritten passes
            t.fill_(float("nan") if t.is_floating_point() else -7)
        fn()
        torch.cuda.synchronize()
        require_equal(what, out, want)
        return timed(fn, symbol)

    for warps, lib in libs.items():
        k1 = entry(lib, "modppl_stats_cumsum_f32", gp._STATS_ARGS)
        k2 = entry(lib, "modppl_positions_cummax_f32", gp._POSITIONS_ARGS)
        row = {"warps": warps,
               "stats_cumsum": held(f"kernel 1 w{warps}", lambda: k1(*args1),
                                    "stats_cumsum_kernel", out1, want1),
               "positions_cummax": held(
                   f"kernel 2 w{warps}", lambda: k2(*args2),
                   "positions_cummax_kernel", out2, want2)}
        result["builds"].append(row)
        print(f"{warps} warps a CTA: stats_cumsum {row['stats_cumsum']}, "
              f"positions_cummax {row['positions_cummax']} (ms L2 cold, us "
              f"profiled, us back to back)")
        sys.stdout.flush()

    lib = libs[gp.GRID_WARPS]
    empty = entry(lib, "probe_empty_grid", gp._STATS_ARGS)
    copy = entry(lib, "probe_copy", _COPY_ARGS)
    dst = torch.empty_like(lw)
    floors = {
        "empty_grid": timed(lambda: empty(*args1), "empty_grid_kernel"),
        "copy_8mb": timed(lambda: copy(lw.data_ptr(), dst.data_ptr(),
                                       N // 4), "copy_kernel"),
    }
    if not torch.equal(dst, lw):
        raise AssertionError("probe_copy: the copy differs from its source")
    result["floors"] = floors
    print(f"floors: {floors}")

    alts = {}
    for name, symbol in (("probe_contig_stats", "contig_stats_kernel"),
                         ("probe_twoscan_stats", "twoscan_stats_kernel"),
                         ("probe_legacy_stats", "legacy_stats_kernel")):
        fn = entry(lib, name, gp._STATS_ARGS)
        alts[name] = held(name, lambda fn=fn: fn(*args1), symbol, out1, want1)
    for name, symbol in (
            ("probe_strided_positions", "strided_positions_kernel"),
            ("probe_contig_positions", "contig_positions_kernel"),
            ("probe_legacy_positions", "legacy_positions_kernel")):
        fn = entry(lib, name, gp._POSITIONS_ARGS)
        alts[name] = held(name, lambda fn=fn: fn(*args2), symbol, out2, want2)
    result["alternatives"] = alts
    for k, v in alts.items():
        print(f"{k}: {v}")

    phases = {}
    stats_phase = entry(lib, "probe_stats_phase", (ctypes.c_int,)
                        + gp._STATS_ARGS)
    positions_phase = entry(lib, "probe_positions_phase", (ctypes.c_int,)
                            + gp._POSITIONS_ARGS)
    for p in range(4):
        phases[f"stats_phase{p}"] = timed(
            lambda p=p: stats_phase(p, *args1), f"stats_phase_kernel<{p}>")
    for p in range(3):
        phases[f"positions_phase{p}"] = timed(
            lambda p=p: positions_phase(p, *args2),
            f"positions_phase_kernel<{p}>")
    result["phases"] = phases
    for k, v in phases.items():
        print(f"{k}: {v}")
    sass = sass_counts(_build.BUILD / "probes" / f"grid_cost_w{gp.GRID_WARPS}"
                       ".so")
    result["sass"] = sass
    for k, v in sass.items():
        print(f"sass {k}: {v}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
