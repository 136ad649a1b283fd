"""Drive modppl_tpu_torch's main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

The main path is the spiral-tracking bootstrap particle filter
(``parallel/sharded_smc.sharded_batched_particle_filter``, one device,
auto-batched, ``ess_threshold=1.0``) at N = 2^20 particles and T = 10 steps
in float32: one init and 9 steps, each of which resamples through the
port's three hand-written CUDA kernels. Phases, in order; any failure raises
and the script exits non-zero:

1. needs a CUDA device, and prints the card's name and power limit;
2. builds the kernels from ``modppl_tpu_torch/csrc/`` with nvcc;
3. holds each kernel against its plain PyTorch version on the card, at
   N = 2^20 and 2^16 with uniform, concentrated and degenerate weights:
   the scan, the positions S, the ancestors and the copied states must all
   be bitwise equal;
4. runs the main path with the launch counters at 0 and requires 9 launches
   of each kernel, a finite log-ML, finite states and sorted ancestors;
   reruns it on the card through the plain versions, fed the same draws,
   and requires every output bitwise equal; then reruns it on the CPU fed
   the same draws and requires the first resample's ancestors and the
   log-ML to agree within the bounds below (CUDA's and the CPU's exp, cos
   and sin round differently, which the filter amplifies step by step);
5. times the filter (median of 5 after a warm-up) and each kernel against
   its plain version at N = 2^20 (CUDA events, L2 flushed before each
   launch; median of 20).

``--profile`` adds a torch.profiler breakdown of one filter run by kernel.
The last three lines are the kernels' JSON record, the card's
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 20
T = 10
CHECK_SIZES = (1 << 20, 1 << 16)
KINDS = ("uniform", "concentrated", "degenerate")
# GPU vs CPU on the same draws: CUDA's and the CPU's exp, cos and sin round
# differently, and a particle whose ancestor flips moves every later slot of
# the systematic grid, so the two runs part after the first resample or two.
# What stays comparable: the first resample's ancestors, and the log-ML up
# to Monte Carlo error (seed-to-seed sd 0.0084 at N = 2^20 on an H100).
LOG_ML_GAP = 0.05
FIRST_STEP_AGREEMENT = 0.99


def card_line():
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_lw(kind, n, seed, device):
    """Log-weights: uniform-ish, concentrated (scale 30) or degenerate (one
    finite weight), float32, made from a numpy seed."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        lw = rng.standard_normal(n) * 0.7
    elif kind == "concentrated":
        lw = rng.standard_normal(n) * 30.0
    else:
        lw = np.full(n, -np.inf)
        lw[rng.integers(n)] = 0.0
    return torch.from_numpy(lw.astype(np.float32)).to(device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Errors:
    """The largest kernel-vs-plain difference seen per kernel."""

    def __init__(self):
        self.max = {}

    def same(self, name, what, got, want):
        err = (got.double() - want.double()).abs()
        both_inf = torch.isinf(got) & torch.isinf(want) & (got == want)
        err = float(torch.where(both_inf, 0.0, err).max()) if err.numel() else 0.0
        self.max[name] = max(self.max.get(name, 0.0), err)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: {what} differs from the plain "
                                 f"version (max abs err {err})")


def check_kernels(device, sizes=CHECK_SIZES, kinds=KINDS):
    """Phase 3: every kernel against its plain version on ``device``."""
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp
    from modppl_tpu_torch.parallel import sharded_smc as smc

    errs = Errors()
    for n in sizes:
        block = smc._cdf_block(n)
        for seed, kind in enumerate(kinds):
            lw = make_lw(kind, n, seed, device)
            rows, m = lw.reshape(-1, block), lw.max()
            got = gp.stats_cumsum(rows, m)
            want = gp.stats_cumsum_plain(rows, m)
            for what, a, b in zip(("cum", "totals", "sq_totals"), got, want):
                errs.same("stats_cumsum", f"{what} (N={n}, {kind})", a, b)
            sync(device)

            cum, totals, _ = want
            offs_incl = gp.doubling_cumsum(totals[None, :])[0]
            offs = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
            total = offs_incl[-1]
            u = torch.tensor(0.37, dtype=torch.float32, device=device)
            got = gp.positions_cummax(cum, offs, total, u, n)
            want = gp.positions_cummax_plain(cum, offs, total, u, n)
            for what, a, b in zip(("s_rows", "row maxima"), got, want):
                errs.same("positions_cummax", f"{what} (N={n}, {kind})", a, b)
            s, _, _ = smc._det_grid_positions(u, lw, n)
            s_plain = torch.maximum(
                want[0], torch.cat([torch.full((1,), -2 ** 31,
                                               dtype=torch.int32,
                                               device=device),
                                    torch.cummax(want[1], 0).values[:-1]]
                                   )[:, None]).reshape(n)
            errs.same("positions_cummax", f"S (N={n}, {kind})", s, s_plain)
            sync(device)

            g = torch.Generator(device=device).manual_seed(seed)
            for c in (1, 2, 7):
                state = torch.randn(c, n, generator=g, device=device)
                got = fr.resample_fused_from_s(s, state)
                want = fr.resample_fused_plain(s, state)
                errs.same("resample_fused_from_s", f"states (N={n}, C={c}, "
                          f"{kind})", got[0], want[0])
                errs.same("resample_fused_from_s", f"parents (N={n}, C={c}, "
                          f"{kind})", got[1], want[1])
            state_nc = torch.randn(n, 2, generator=g, device=device)
            got = fr.resample_fused_from_s(s, state_nc, layout="nc")
            want = fr.resample_fused_plain(s, state_nc, layout="nc")
            errs.same("resample_fused_from_s", f"(N, C) states (N={n}, "
                      f"{kind})", got[0], want[0])
            if kind == "degenerate" and int(got[1].unique().numel()) != 1:
                raise AssertionError("degenerate weights: expected a single "
                                     "ancestor")
            sync(device)
    return errs.max


def run_filter(device, n, seed, **kwargs):
    """The main path: the spiral filter on ``device`` in float32."""
    from modppl_tpu_torch.core.trie import Trie
    from modppl_tpu_torch.models.spiral import (
        circle_observations,
        spiral_scan_kernel,
    )
    from modppl_tpu_torch.parallel.sharded_smc import (
        sharded_batched_particle_filter,
    )

    obs = torch.tensor(circle_observations(T), dtype=torch.float32,
                       device=device)
    return sharded_batched_particle_filter(
        None, seed, spiral_scan_kernel(),
        torch.zeros(2, dtype=torch.float32, device=device),
        Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}),
        n, ess_threshold=1.0, auto_batch=True, **kwargs)


def wrappers():
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp

    return {"stats_cumsum": gp.stats_cumsum,
            "positions_cummax": gp.positions_cummax,
            "resample_fused_from_s": fr.resample_fused_from_s}


@contextlib.contextmanager
def plain_versions():
    """Run the main path with each kernel's plain version in its place. On
    a CUDA tensor the wrappers only launch kernels, so the reference run on
    the card swaps the functions the filter calls."""
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp
    from modppl_tpu_torch.parallel import resample
    from modppl_tpu_torch.parallel import sharded_smc as smc

    swaps = [(smc, "stats_cumsum", gp.stats_cumsum_plain),
             (smc, "positions_cummax", gp.positions_cummax_plain),
             (resample, "resample_fused_from_s", fr.resample_fused_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_main_path(device, n=N, seed=7):
    """Phase 4: one counted run on ``device``; the same filter with the
    plain versions on ``device``, fed the same draws, must be bitwise
    equal; the same filter on the CPU, fed the same draws, must agree on
    the first resample and stay within LOG_ML_GAP of the log-ML. Returns
    (launches by kernel, a dict of what was seen)."""
    fns = wrappers()
    for fn in fns.values():
        fn.launches = 0
    rec = []
    out = run_filter(device, n, seed, record=rec)
    sync(device)
    launches = {name: fn.launches for name, fn in fns.items()}
    for name, count in launches.items():
        if count != T - 1:
            raise AssertionError(f"{name}: {count} launches on the main path, "
                                 f"expected {T - 1}")

    log_ml = float(out["log_ml"])
    anc = out["ancestors"]
    if not math.isfinite(log_ml):
        raise AssertionError(f"log_ml is not finite: {log_ml}")
    if out["state"].shape != (n, 2) or not bool(out["state"].isfinite().all()):
        raise AssertionError("final states: expected finite (N, 2) values")
    if anc.shape != (T - 1, n) or bool((anc[:, 1:] < anc[:, :-1]).any()):
        raise AssertionError("ancestors: expected sorted (T-1, N) indices")
    ess = out["ess"].double().cpu()
    if not bool(((ess > 0) & (ess <= n * (1 + 1e-5))).all()):
        raise AssertionError(f"ESS out of (0, N]: {ess.tolist()}")

    with plain_versions():
        plain = run_filter(device, n, seed, replay=rec)
    for what in ("log_ml", "ancestors", "state", "log_weights", "ess"):
        if not torch.equal(out[what], plain[what]):
            raise AssertionError(f"main path: {what} differs from the same "
                                 f"filter through the plain versions")

    replay = [(None if u is None else u.cpu(),
               {a: v.cpu() for a, v in pool.items()}) for u, pool in rec]
    cpu = run_filter("cpu", n, seed, replay=replay)
    gap = abs(log_ml - float(cpu["log_ml"]))
    agree = (anc.cpu() == cpu["ancestors"]).double().mean(dim=1).tolist()
    seen = {"log_ml": log_ml, "log_ml_cpu": float(cpu["log_ml"]),
            "log_ml_gap": gap, "parent_agreement": agree}
    if gap > LOG_ML_GAP:
        raise AssertionError(f"log_ml GPU {log_ml} vs CPU "
                             f"{float(cpu['log_ml'])}: gap {gap}")
    if agree[0] < FIRST_STEP_AGREEMENT:
        raise AssertionError(f"first resample: GPU and CPU ancestors agree "
                             f"on only {agree[0]} of the slots")
    return launches, seen


def time_filter(n=N, runs=5):
    """Median seconds of one filter on the card after one warm-up run."""
    run_filter("cuda", n, 100, store_ancestry=False)
    torch.cuda.synchronize()
    times = []
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_filter("cuda", n, 101 + i, store_ancestry=False)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not math.isfinite(float(out["log_ml"])):
            raise AssertionError("timed run: log_ml is not finite")
    return statistics.median(times), times


def time_ms(fn, reps=20):
    """Median device ms of ``fn`` with L2 flushed before each launch."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def time_kernels(n=N):
    """(kernel ms, plain ms) per kernel at the main path's shapes."""
    from modppl_tpu_torch.ops import fused_resample as fr
    from modppl_tpu_torch.ops import grid_positions as gp
    from modppl_tpu_torch.parallel import sharded_smc as smc

    lw = make_lw("uniform", n, 0, "cuda")
    rows, m = lw.reshape(-1, smc._cdf_block(n)), lw.max()
    cum, totals, _ = gp.stats_cumsum_plain(rows, m)
    offs_incl = gp.doubling_cumsum(totals[None, :])[0]
    offs = torch.cat([totals.new_zeros(1), offs_incl[:-1]])
    total = offs_incl[-1]
    u = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    s, _, _ = smc._det_grid_positions(u, lw, n)
    state = torch.randn(n, 2, device="cuda")
    pairs = {
        "stats_cumsum": (lambda: gp.stats_cumsum(rows, m),
                         lambda: gp.stats_cumsum_plain(rows, m)),
        "positions_cummax": (
            lambda: gp.positions_cummax(cum, offs, total, u, n),
            lambda: gp.positions_cummax_plain(cum, offs, total, u, n)),
        "resample_fused_from_s": (
            lambda: fr.resample_fused_from_s(s, state, layout="nc"),
            lambda: fr.resample_fused_plain(s, state, layout="nc")),
    }
    out = {}
    for name, (kernel, plain) in pairs.items():
        # turns: plain, kernel, kernel, plain; each reported as its median
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                          time_ms(plain))
        out[name] = (statistics.median([k1, k2]), statistics.median([p1, p2]))
    return out


def profile_filter(median_s, n=N):
    """Device time of one filter run by kernel and copy, and the device's
    idle share of the unprofiled median wall time ``median_s``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_filter("cuda", n, 201, store_ancestry=False)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    print(f"# profile: {sum(r[2] for r in rows)} device ops, busy "
          f"{busy_ms:.3f} ms of a {median_s * 1e3:.3f} ms filter: idle share "
          f"{1 - busy_ms / (median_s * 1e3):.3f}")
    for key, ms, count in rows[:15]:
        print(f"#   {ms:8.3f} ms  x{count:<4d} {key[:100]}")


SOURCES = {
    "stats_cumsum": ("modppl_tpu_torch/csrc/grid_positions.cu",
                     "modppl_tpu/ops/grid_positions_pallas.py:59"),
    "positions_cummax": ("modppl_tpu_torch/csrc/grid_positions.cu",
                         "modppl_tpu/ops/grid_positions_pallas.py:99"),
    "resample_fused_from_s": ("modppl_tpu_torch/csrc/fused_resample.cu",
                              "modppl_tpu/ops/fused_resample_pallas.py:101"),
}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    sys.stdout.flush()

    from modppl_tpu_torch.ops import _build

    path, seconds, log = _build.build()
    print(f"# build: {seconds:.2f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"#   {line.strip()}")
    sys.stdout.flush()

    errs = check_kernels("cuda")
    print(f"# kernels == plain versions on the card, bitwise: N in "
          f"{list(CHECK_SIZES)}, weights {list(KINDS)}")
    sys.stdout.flush()

    launches, seen = check_main_path("cuda")
    print(f"# main path: spiral filter N={N} T={T} float32 on cuda; "
          f"launches {launches}")
    print("# main path == the same filter through the plain versions on the "
          "card, bitwise")
    print(f"# log_ml GPU {seen['log_ml']!r} CPU {seen['log_ml_cpu']!r} "
          f"gap {seen['log_ml_gap']!r}; ancestors equal per step on "
          f"{[round(a, 6) for a in seen['parent_agreement']]} of the slots")
    sys.stdout.flush()

    median_s, times = time_filter()
    print(f"# filter: median {median_s * 1e3:.3f} ms of "
          f"{[round(t * 1e3, 3) for t in times]} ms -> "
          f"{N * T / median_s:.1f} particle-steps/s ({card})")
    timings = time_kernels()
    for name, (k_ms, p_ms) in timings.items():
        print(f"# {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms at N={N}")
    if "--profile" in argv:
        profile_filter(median_s)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": errs[name], "ms": timings[name][0],
         "plain_ms": timings[name][1]}
        for name in SOURCES]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
