"""A configuration, a traffic mix and a metric are added as new files and
entries, and the harness runs the new cell and its control without an
edit to any file it already had."""

import hashlib
import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent

NEW_FILES = {
    "configs/toy-sum.json": {"name": "toy-sum", "scale": 2.0},
    "configs/toy-sum.py": """
        import torch

        class Cell:
            def __init__(self, cfg, spec, seed, device):
                self.cfg, self.device, self.outs = cfg, device, []

            def warm(self, job):
                self.dispatch(job)

            def dispatch(self, job):
                g = torch.Generator().manual_seed(job["key"] % (1 << 63))
                x = torch.rand(job["n"], generator=g)
                return x, self.cfg["scale"] * x.sum()

            def record(self, job, out, keep):
                self.outs.append(out)

            def summary(self):
                return {"work": {"items": sum(x.numel() for x, _ in self.outs)}}

            def check(self, ref, limits):
                gap = max(ref.gap(self.cfg, x, y) for x, y in self.outs)
                return {"sum_gap": (gap, limits["sum_gap"])}
        """,
    "reference/toy-sum.py": """
        import torch

        def gap(cfg, x, y):
            return abs(float(y) - cfg["scale"] * float(x.double().sum()))

        def control_numbers(cfg, spec, job, seed, device, units=None):
            g = torch.Generator().manual_seed(job["key"] % (1 << 63))
            x = torch.rand(job["n"], generator=g)
            y = cfg["scale"] * x.to(torch.bfloat16).sum()
            return {"sum_gap": gap(cfg, x, y)}
        """,
    "reference/toy-sum.limits.json": {"sum_gap": 1e-3},
    "counts/toy-sum.py": """
        def counts(cfg, spec):
            n = spec["units"][0]["n"]
            return {"unit": {"bytes": 4 * n, "flops": n}, "groups": {}}
        """,
    "traffic/toy-sum.small.json": {"loop": "closed", "units": [{"n": 1000}]},
    "metrics/items_per_s.py": """
        def read(rec):
            return rec["work"]["items"] / rec["window_s"]
        """,
    "metrics/units_seen.toy.py": """
        def read(rec):
            return float(rec["units"])
        """,
}


def digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_needs_only_new_files_and_entries(tmp_path):
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path / "portbench")
    for rel, body in NEW_FILES.items():
        path = tmp_path / "portbench" / rel
        path.write_text(json.dumps(body) if isinstance(body, dict)
                        else textwrap.dedent(body))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-sum", "source": "https://example.org",
                             "file": "portbench/configs/toy-sum.json",
                             "reduced": [], "why": "a test of the layout"})
    bench["workloads"].append({"name": "toy-sum.small", "config": "toy-sum",
                               "traffic": "small", "chips": 1,
                               "why": "a test of the layout"})
    bench["end_to_end"].append({"name": "items_per_s", "unit": "items/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["toy-sum.small"]})
    bench["per_layer"].append({"name": "units_seen.toy", "unit": "units",
                               "better": "higher", "source": "host_clock",
                               "layer": "toy", "moves": "items_per_s",
                               "workloads": ["toy-sum.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, ".")
        from portbench.run import run_cell
        from portbench.control import control_numbers
        for trace in (False, True):
            r = run_cell("toy-sum.small", 5, 0.2, trace, "cpu")
            print(json.dumps({k: r[k] for k in ("correct", "metrics")}))
        print(json.dumps(control_numbers("toy-sum.small", 5, device="cpu")))
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin",
                               "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    untraced, traced, control = (json.loads(l)
                                 for l in proc.stdout.splitlines()[-3:])
    assert untraced["correct"] and traced["correct"]
    # the control, found by name as the run's parts are, fails the check
    assert any(v > lim for v, lim in control.values()), control
    assert set(untraced["metrics"]) == {"items_per_s", "setup_s"}
    assert set(traced["metrics"]) == {"units_seen.toy"}
    after = digest(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
