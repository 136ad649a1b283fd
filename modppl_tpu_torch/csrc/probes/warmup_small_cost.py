"""Where an iteration of ``hmc_warmup_chunk_small`` (kernel 10,
csrc/hmc_small.cu) goes, at the hierarchical leg's shapes (10^4 chains,
d = 3, 300 iterations): builds and runs ``grid_sync.cu`` beside this file
(the cost of one grid.sync()), then times the kernel through its C entry
with the leapfrog steps at 8 (the leg's) and at 0, and with the leg's slow
windows on and off (no slow window: no squared-deviation pass, one
grid.sync() an iteration). Not part of the port; run from the repository
root on one CUDA device:

    python3 modppl_tpu_torch/csrc/probes/warmup_small_cost.py
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from modppl_tpu_torch.ops import _build  # noqa: E402
from modppl_tpu_torch.ops import leapfrog_small as lfs  # noqa: E402
from modppl_tpu_torch.ops._hmc_common import (  # noqa: E402
    launch,
    schedule_arrays,
)


def grid_sync_costs():
    exe = _build.BUILD / "probes" / "grid_sync"
    exe.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), "-O3", "-std=c++17", *_build.ARCH_FLAGS,
                    "-o", str(exe), str(Path(__file__).with_name(
                        "grid_sync.cu"))], check=True)
    return subprocess.run([str(exe)], check=True, capture_output=True,
                          text=True).stdout


def warmup_ms(args, steps, slow):
    """Median ms of kernel 10 on ``args`` (chip_smoke.leg_inputs), with
    ``steps`` leapfrog steps and the slow windows on or off."""
    u0, z, jit, u01, lam, b, eps0, _ = args
    n, d = u0.shape
    num = z.shape[0]
    sch, nwin = schedule_arrays(num, "cuda")
    ntiles = -(-n // lfs.WARMUP_TILE)
    part = torch.zeros(2, 1 + 2 * d, 1 << (ntiles - 1).bit_length(),
                       device="cuda")
    us = u0.clone()
    eps = torch.empty((), device="cuda")
    im = torch.empty(d, device="cuda")

    def run():
        launch("modppl_hmc_warmup_small_f32", lfs._WARMUP_ARGS,
               "hmc_warmup_chunk_small", u0.device, us.data_ptr(),
               z.data_ptr(), jit.data_ptr(), u01.data_ptr(), lam.data_ptr(),
               b.data_ptr(), n, d, num, steps, float(eps0),
               float(10 * eps0), 0.8, nwin if slow else 0, sch.data_ptr(),
               part.data_ptr(), eps.data_ptr(), im.data_ptr())

    return cs.time_ms(run, reps=5, warmup=1)


def main():
    print(f"# {cs.card_line()}")
    _build.build()
    print(grid_sync_costs(), end="")
    args, _ = cs.leg_inputs("hierarchical")
    for steps in (8, 0):
        for slow in (True, False):
            print(f"warmup_small steps={steps} slow_windows={slow}: "
                  f"{warmup_ms(args, steps, slow):.4f} ms")


if __name__ == "__main__":
    main()
