"""Runs one cell of the benchmark once and prints one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, inputs from the seed, one warm unit of every shape the
cell sends) runs first; then the window sends the cell's mix for
``--seconds`` seconds; then, with the window closed and the memory peak
read, the correctness check runs the plain reference. With ``--trace 0``
the line carries the cell's end-to-end metrics; with ``--trace 1`` CUDA events
are recorded around every unit of the window, a few more units
run under the profiler after it, and the line carries the cell's per-layer
metrics and a breakdown of the profiled units. The numbers compared for
``correct`` come last, on standard error and in the line under
``checks``.

Exits non-zero with no result when there is no CUDA device (or fewer than
the cell's chips), when the program is missing, and when a module of JAX
or of the JAX package is loaded at the end.
"""

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()
REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# Build and kernel caches at fixed paths inside the checkout, so only a
# checkout's first run builds. The program's CUDA library is built under
# modppl_tpu_torch/_build/ by the program itself.
CACHE = REPO / ".portbench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(CACHE / _sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

#: top-level module names a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "modppl_tpu")


def process_age_s():
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def require_card(chips):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device; the benchmark runs on "
                         "the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} found")


def power_limit_w():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(cell, jobs, seconds, trace, device, loop, keep_index):
    """Send the mix for ``seconds``. Returns the record's window part: its
    wall, the units sent, each unit's wall in a closed loop, and with
    ``trace`` each unit's time between CUDA events recorded just before
    and just after its dispatch."""
    import torch

    timed = trace and torch.device(device).type == "cuda"
    events, walls, units = [], [], 0
    t0 = time.perf_counter()
    while True:
        job = next(jobs)
        ts = time.perf_counter()
        if timed:
            pair = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            pair[0].record()
        out = cell.dispatch(job)
        if timed:
            pair[1].record()
            events.append(pair)
        if loop == "closed":
            sync(device)
            walls.append(time.perf_counter() - ts)
        cell.record(job, out, keep=job["index"] == keep_index)
        units += 1
        del out
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    return {"window_s": window_s, "units": units, "walls_s": walls,
            "event_ms": [a.elapsed_time(b) for a, b in events]}


def run_cell(workload, seed, seconds, trace, device="cuda", bench=None,
             overrides=None, t_setup0=None):
    """One run of ``workload``; returns the result dict. ``overrides``
    replaces entries of the configuration and the mix (tests run a cell at
    a small size on the CPU with it)."""
    from portbench import loader, mix as mixes
    import torch

    bench = bench or loader.benchmark()
    w = loader.workload(bench, workload)
    cfg, cell_module = loader.config(w["config"])
    spec = loader.traffic(workload)
    if overrides:
        cfg = {**cfg, **overrides.get("config", {})}
        spec = {**spec, **overrides.get("traffic", {})}
    mixes.check_mix(spec)
    jobs = mixes.jobs(spec, seed)

    # set-up: the program, the inputs, one warm unit of each shape
    cell = cell_module.Cell(cfg, spec, seed, device)
    for job in mixes.warm_jobs(spec, seed):
        cell.warm(job)
    sync(device)
    setup_s = t_setup0() if t_setup0 else 0.0

    keep_index = mixes.checked_index(seed)
    rec = window(cell, jobs, seconds, trace, device, spec["loop"],
                 keep_index)
    rec["setup_s"] = setup_s
    on_card = torch.device(device).type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    profile = None
    if trace:
        from portbench import trace as tracing

        k = spec.get("profiled_units", 3)

        def profiled():
            for _ in range(k):
                out = cell.dispatch(next(jobs))
                if spec["loop"] == "closed":
                    sync(device)
                del out
            sync(device)

        profile = tracing.capture(profiled, k)
    rec.update(cell.summary())
    rec["profile"] = profile
    rec["counts"] = loader.counts(w["config"]).counts(cfg, spec)
    rec["peaks"] = loader.peaks()

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in loader.metrics_for(bench, workload, kind):
        value = loader.metric(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, after the window, with the program's state released
    ref, limits = loader.reference(w["config"])
    checks = cell.check(ref, limits)
    correct = (all(math.isfinite(v) and v <= lim
                   for v, lim in checks.values())
               and rec.get("failed", 0) == 0)

    result = {"correct": correct, "attempted": rec["units"],
              "failed": rec.get("failed", 0), "metrics": metrics}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": w["chips"], "memory_peak_bytes": memory_peak,
                   "power_limit_w": power_limit_w() if on_card else None}
    if profile is not None:
        device_info["busy_s"] = profile.busy_s
        device_info["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": profile.top_ops(),
                               "idle_gaps": profile.idle_gaps()}
    result["device"] = device_info
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result


def main(argv=None):
    t_main = time.perf_counter()
    age0 = process_age_s()

    def since_start():
        return age0 + (time.perf_counter() - t_main)

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import loader

    bench = loader.benchmark()
    w = loader.workload(bench, args.workload)
    require_card(w["chips"])
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", bench,
                      t_setup0=since_start)
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"portbench: modules of JAX or the JAX package "
                         f"were loaded: {', '.join(found)}\n")
        return 3
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']!r} limit "
                         f"{c['limit']!r}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
