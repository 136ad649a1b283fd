"""Cases of tests/test_torch_sharded_batched.py, run on every rank of a
spawned gloo group (tests/_torch_dist.py): the sharded batched filter and
its resample step at dp = 1, 2 and the world's size. Each case returns
rank 0's view, the per-particle outputs gathered in shard order."""

import math

import numpy as np
import torch
import torch.distributed as dist

from modppl_tpu_torch.core import Trie, select
from modppl_tpu_torch.dists import normal, plate
from modppl_tpu_torch.inference.vsmc import ScanKernel
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.models.spiral import spiral_scan_kernel
from modppl_tpu_torch.parallel import collectives, sharded_smc
from modppl_tpu_torch.parallel.mesh import make_mesh

N = 1024
T = 6
A, Q, R = 0.9, 0.5, 0.3
PREC = 1.0 / Q ** 2 + 1.0 / R ** 2
YS = np.array([0.3, 0.5, 0.1, -0.2, 0.4, 0.9, 0.7, 0.2])
OUTPUTS = ("log_ml", "log_weights", "state", "ancestors", "ess", "resampled")
_MESHES = {}


def meshes():
    """dp = 1 (rank 0), dp = 2 (ranks 0-1) and dp = world, made once in the
    same order on every rank."""
    if not _MESHES:
        world = dist.get_world_size()
        _MESHES.update({1: make_mesh(dp=1, ranks=[0]),
                        2: make_mesh(dp=2, ranks=[0, 1]),
                        world: make_mesh(dp=world)})
    return _MESHES


def world_mesh():
    return meshes()[dist.get_world_size()]


def spiral_data(num_steps=T):
    """tests/test_sharded_batched.py:44-53's observations, float32."""
    rng = np.random.default_rng(0)
    obs = np.stack([(0.4 * np.array([np.cos(a), np.sin(a)])
                     + 0.01 * rng.standard_normal(2)).astype(np.float32)
                    for a in np.linspace(0.0, 2.0, num_steps)])
    obs = torch.from_numpy(obs)
    return Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]})


def gathered(mesh, out):
    """The filter's outputs with the per-particle ones gathered whole."""
    res = {}
    for k in OUTPUTS + ("acceptance",):
        v = out.get(k)
        if v is None:
            continue
        if k in ("state", "log_weights"):
            v = mesh.gather(v)
        elif k == "ancestors":
            v = mesh.gather(v.t().contiguous()).t()
        res[k] = v.numpy()
    return res


def run_spiral(mesh, **kw):
    """The spiral filter's outputs, gathered, and what its collectives
    moved (before the gathers)."""
    init_c, step_c = spiral_data()
    collectives.reset_counts()
    out = sharded_smc.sharded_batched_particle_filter(
        mesh, 3, spiral_scan_kernel(), torch.zeros(2), init_c, step_c, N,
        auto_batch=True, device="cpu", **kw)
    moved = collectives.counts()
    return gathered(mesh, out), moved


def across(label_kw, **kw):
    """The spiral at every mesh of ``label_kw`` (dp values), each rank in
    the meshes it belongs to; rank 0's outputs, keyed ``dp<k>/<output>``,
    with the exchanges and collectives' counts of the world's run."""
    res = {}
    world = dist.get_world_size()
    for dp in label_kw:
        mesh = meshes()[dp]
        if not mesh.member:
            continue
        sharded_smc.exchanges.update(halo=0, ring=0)
        out, c = run_spiral(mesh, **kw)
        res.update({f"dp{dp}/{k}": v for k, v in out.items()})
        if dp == world:
            res.update({f"count/{op}/{f}": c.get(op, {}).get(f, 0)
                        for op in ("all_gather", "pmax", "ppermute")
                        for f in ("calls", "bytes", "max_bytes")})
            res["count/host_copies"] = c["host_copies"]
            res.update({f"exchanges/{p}": n
                        for p, n in sharded_smc.exchanges.items()})
    return res


def case_layout(_):
    return across((1, 2, dist.get_world_size()))


def case_threshold(_):
    return across((1, dist.get_world_size()), ess_threshold=0.1)


def case_tiny_halo(_):
    return across((1, dist.get_world_size()), halo=1)


def _local(mesh, x):
    return x[mesh.local(x.shape[0])]


def _step(mesh, inputs, prefix, halo):
    lw = torch.from_numpy(inputs[f"{prefix}_lw"])
    state = torch.from_numpy(inputs[f"{prefix}_state"])
    u = torch.from_numpy(inputs[f"{prefix}_u"])
    step = sharded_smc.make_resample_step(mesh, lw.shape[0], 1.0, halo=halo)
    sharded_smc.exchanges.update(halo=0, ring=0)
    collectives.reset_counts()
    with mesh:
        new, lw_out, dml, parents, ess, do = step(
            0, _local(mesh, lw), _local(mesh, state), u=u)
        moved = collectives.counts()
        s, log_total, ess_s = sharded_smc._det_grid_positions(
            u, _local(mesh, lw), lw.shape[0], "dp")
        lse = sharded_smc.det_logsumexp(_local(mesh, lw), lw.shape[0], "dp")
        return {"state": mesh.gather(new).numpy(),
                "parents": mesh.gather(parents).numpy(),
                "lw": mesh.gather(lw_out).numpy(), "dml": dml.numpy(),
                "ess": ess.numpy(), "do": do.numpy(),
                "s": mesh.gather(s).numpy(), "log_total": log_total.numpy(),
                "ess_s": ess_s.numpy(), "lse": lse.numpy(),
                "halo": sharded_smc.exchanges["halo"],
                "ring": sharded_smc.exchanges["ring"],
                "ppermute_bytes": moved.get("ppermute", {}).get("bytes", 0),
                "all_gather_max": moved["all_gather"]["max_bytes"]}


def case_reference_step(inputs):
    """The resample step at dp = world on the reference's inputs: the halo
    path (default halo) and the ring (halo 1); and the degenerate weights
    (all mass on N - 3, halo 4)."""
    mesh = world_mesh()
    res = {}
    for tag, prefix, halo in (("halo", "ref", None), ("ring", "ref", 1),
                              ("degenerate", "deg", 4)):
        res.update({f"{tag}/{k}": v
                    for k, v in _step(mesh, inputs, prefix, halo).items()})
    return res


@gen
def lg_init_batched(h, _s0, n):
    x = h.sample(plate(normal, n), (0.0, 1.0), "x")
    h.sample(normal, (x, R), "y")
    return x


@gen
def lg_step_batched(h, t, prev):
    x = h.sample(plate(normal, prev.shape[0]), (A * prev, Q), "x")
    h.sample(normal, (x, R), "y")
    return x


@gen
def lg_init(h, _s0):
    x = h.sample(normal, (0.0, 1.0), "x")
    h.sample(normal, (x, R), "y")
    return x


@gen
def lg_step(h, t, prev):
    x = h.sample(normal, (A * prev, Q), "x")
    h.sample(normal, (x, R), "y")
    return x


@gen
def lg_optimal_proposal(h, t, prev, cons):
    y = cons.read("y")
    m = (A * prev / Q ** 2 + y / R ** 2) / PREC
    h.sample(normal, (m, 1.0 / math.sqrt(PREC)), "x")


def case_kalman(inputs):
    """tests/test_sharded_batched.py:134-160: the batch-aware LG kernel at
    dp = world, 4096 particles, against the exact Kalman log-ML."""
    ys = torch.from_numpy(inputs["kalman_ys"])
    out = sharded_smc.sharded_batched_particle_filter(
        world_mesh(), 11, ScanKernel(lg_init_batched, lg_step_batched),
        torch.zeros((), dtype=torch.float32),
        Trie.from_dict({"y": ys[0]}), Trie.from_dict({"y": ys[1:]}), 4096,
        device="cpu")
    return {"log_ml": out["log_ml"].numpy()}


def case_guided(_):
    """tests/test_sharded_batched.py:202-233: guided and rejuvenated at
    dp = 1 and dp = world, 2048 particles."""
    ys = torch.from_numpy(YS)
    res = {}
    for dp in (1, dist.get_world_size()):
        mesh = meshes()[dp]
        if not mesh.member:
            continue
        out = sharded_smc.sharded_batched_particle_filter(
            mesh, 4, ScanKernel(lg_init, lg_step),
            torch.zeros((), dtype=torch.float64),
            Trie.from_dict({"y": ys[0]}), Trie.from_dict({"y": ys[1:]}), 2048,
            auto_batch=True, proposal=lg_optimal_proposal,
            rejuvenation=(select("x"), 1), device="cpu")
        res.update({f"dp{dp}/{k}": v
                    for k, v in gathered(mesh, out).items()})
    return res


CASES = [case_layout, case_threshold, case_tiny_halo, case_reference_step,
         case_kalman, case_guided]
