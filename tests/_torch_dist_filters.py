"""Cases of tests/test_torch_sharded.py, run on every rank of a spawned
gloo group (tests/_torch_dist.py): meshes, the vmapped filter over shards,
the shard_map-style resampler and logsumexp, the two-process runs of the
reference's tests/test_multiprocess.py (dp = 2, one process a shard) and
the checkpointed sharded filter's resume. Each case returns rank 0's view,
the per-particle outputs gathered in shard order."""

import numpy as np
import torch
import torch.distributed as dist

from modppl_tpu_torch.core import Trie, select
from modppl_tpu_torch.inference.checkpointed import (
    checkpointed_sharded_particle_filter,
)
from modppl_tpu_torch.inference.vsmc import ScanKernel, particle_filter
from modppl_tpu_torch.interop import hmm_params_from_numpy
from modppl_tpu_torch.models.hmm import hmm_scan_kernel
from modppl_tpu_torch.models.spiral import spiral_scan_kernel
from modppl_tpu_torch.parallel import distributed, sharded_smc
from modppl_tpu_torch.parallel.mesh import (
    constrain_particles,
    data_sharding,
    make_mesh,
    particle_sharding,
    replicated,
)

from tests._torch_dist_smc import (
    lg_init,
    lg_optimal_proposal,
    lg_step,
    spiral_data,
)

HMM_DATA = [0, 0, 1, 2]
_MESHES = {}


def meshes():
    """dp = 1 (rank 0), 2 (ranks 0-1), 4 x 2 and dp = world, made once in
    the same order on every rank."""
    if not _MESHES:
        world = dist.get_world_size()
        _MESHES.update({1: make_mesh(dp=1, ranks=[0]),
                        2: make_mesh(dp=2, ranks=[0, 1]),
                        "4x2": make_mesh(dp=4, sp=2),
                        world: make_mesh(dp=world)})
    return _MESHES


def case_mesh_shapes(_):
    m = meshes()
    world = dist.get_world_size()
    x = torch.arange(16)
    grid = m["4x2"]
    return {"world_size": m[world].devices.size,
            "world_dp": m[world].shape["dp"],
            "grid_dp": grid.shape["dp"], "grid_sp": grid.shape["sp"],
            "grid_coords": np.asarray(grid.coords),
            "particles": particle_sharding(grid).local(x).numpy(),
            "data": data_sharding(grid).local(x).numpy(),
            "replicated": replicated(grid).local(x).numpy(),
            "constrained": constrain_particles((x, x[:, None]), grid)[0]
            .numpy()}


def _hmm(inputs):
    params = hmm_params_from_numpy(inputs["hmm_prior"], inputs["hmm_emission"],
                                   inputs["hmm_transition"], device="cpu")
    obs = torch.tensor(HMM_DATA, dtype=torch.int32)
    return (hmm_scan_kernel(params), torch.zeros((), dtype=torch.float64),
            Trie.from_dict({"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}))


def _gather_filter(mesh, out):
    return {"log_ml": out["log_ml"].numpy(),
            "state": mesh.gather(out["state"]).numpy(),
            "log_weights": mesh.gather(out["log_weights"]).numpy(),
            "ancestors": mesh.gather(out["ancestors"].t().contiguous())
            .t().numpy()}


def case_vmapped_filter(inputs):
    """The HMM through ``sharded_particle_filter`` at dp = world (16000
    and 8000 particles), and the one-device ``particle_filter`` of the
    8000 on rank 0."""
    world = dist.get_world_size()
    res = {}
    for n, key in ((16_000, 0), (8000, 1)):
        out = distributed.sharded_particle_filter(
            meshes()[world], key, *_hmm(inputs), n, device="cpu")
        res.update({f"sharded{n}/{k}": v for k, v in
                    _gather_filter(meshes()[world], out).items()})
    if dist.get_rank() == 0:
        ref = particle_filter(1, *_hmm(inputs), 8000, store_traces=False,
                              device="cpu")
        res.update({f"one8000/{k}": ref[k].numpy()
                    for k in ("log_ml", "state", "log_weights",
                              "ancestors")})
    return res


def case_logsumexp(inputs):
    mesh = meshes()[dist.get_world_size()]
    lw = torch.from_numpy(inputs["lse_lw"])
    lse = distributed.distributed_logsumexp_fn(mesh)
    return {"lse": lse(lw[mesh.local(lw.shape[0])]).numpy()}


def _resample(mesh, inputs, prefix):
    lw = torch.from_numpy(inputs[f"{prefix}_lw"])
    state = torch.from_numpy(inputs[f"{prefix}_state"])
    sl = mesh.local(lw.shape[0])
    u = torch.from_numpy(inputs[f"{prefix}_u"])
    new, parents, log_total = distributed.shardmap_resample_fn(mesh)(
        7, lw[sl], state[sl], u=u)
    drawn = distributed.shardmap_resample_fn(mesh)(7, lw[sl], state[sl])
    return {"state": mesh.gather(new).numpy(),
            "parents": mesh.gather(parents).numpy(),
            "log_total": log_total.numpy(),
            "drawn_parents": mesh.gather(drawn[1]).numpy()}


def case_resample_across_shard_counts(inputs):
    """``shardmap_resample_fn`` at dp = 1, 2, 4 x 2 (its dp axis) and
    world, on the reference's uniform and on the port's own draw."""
    res = {}
    for dp in (1, 2, "4x2", dist.get_world_size()):
        mesh = meshes()[dp]
        if mesh.member:
            res.update({f"dp{dp}/{k}": v for k, v in
                        _resample(mesh, inputs, "rs").items()})
    return res


def case_two_process_resample(inputs):
    """tests/test_multiprocess.py's first case at dp = 2 and dp = 1."""
    res = {}
    for dp in (1, 2):
        if meshes()[dp].member:
            res.update({f"dp{dp}/{k}": v for k, v in
                        _resample(meshes()[dp], inputs, "mp").items()})
    return res


def _spiral(mesh):
    init_c, step_c = spiral_data()
    return sharded_smc.sharded_batched_particle_filter(
        mesh, 3, spiral_scan_kernel(), torch.zeros(2), init_c, step_c, 1024,
        auto_batch=True, device="cpu")


def _guided(mesh, ys):
    return sharded_smc.sharded_batched_particle_filter(
        mesh, 4, ScanKernel(lg_init, lg_step),
        torch.zeros((), dtype=torch.float64),
        Trie.from_dict({"y": ys[0]}), Trie.from_dict({"y": ys[1:]}), 2048,
        auto_batch=True, proposal=lg_optimal_proposal,
        rejuvenation=(select("x"), 1), device="cpu")


def case_two_process_filter(inputs):
    """tests/test_multiprocess.py's third case: the sharded filter,
    bootstrap and guided, at dp = 2 and dp = 1."""
    ys = torch.from_numpy(inputs["lg_ys"])
    res = {}
    for dp in (1, 2):
        mesh = meshes()[dp]
        if not mesh.member:
            continue
        for tag, out in (("filter", _spiral(mesh)),
                         ("guided", _guided(mesh, ys))):
            res.update({f"{tag}/dp{dp}/{k}": v for k, v in
                        _gather_filter(mesh, out).items()})
    return res


def _checkpointed(mesh, path, step_c, **kw):
    init_c, _ = spiral_data()
    return checkpointed_sharded_particle_filter(
        mesh, 11, spiral_scan_kernel(), torch.zeros(2), init_c, step_c, 1024,
        checkpoint_path=path, checkpoint_every=3, auto_batch=True,
        device="cpu", **kw)


def case_checkpoint_resume(inputs):
    """tests/test_checkpointed.py:119-169 at dp = 1 and dp = world: a
    full run, and one interrupted at step 3 then resumed from its
    checkpoint with the full constraints; the files written by rank 0."""
    workdir = str(inputs["workdir"])
    _, step_c = spiral_data(9)
    head = step_c.map(lambda v: v[:3])
    res = {}
    for dp in (1, dist.get_world_size()):
        mesh = meshes()[dp]
        if not mesh.member:
            continue
        full = _checkpointed(mesh, f"{workdir}/full_dp{dp}", step_c)
        cut = f"{workdir}/cut_dp{dp}"
        _checkpointed(mesh, cut, head)
        resumed = _checkpointed(mesh, cut, step_c, resume_from=cut)
        for tag, out in (("full", full), ("resumed", resumed)):
            res.update({f"dp{dp}/{tag}/state": mesh.gather(out["state"])
                        .numpy(),
                        f"dp{dp}/{tag}/log_weights":
                        mesh.gather(out["log_weights"]).numpy(),
                        f"dp{dp}/{tag}/log_ml": out["log_ml"].numpy(),
                        f"dp{dp}/{tag}/t": out["t"]})
        res[f"dp{dp}/one_shot/state"] = mesh.gather(
            _one_shot(mesh, step_c)["state"]).numpy()
    return res


def _one_shot(mesh, step_c):
    init_c, _ = spiral_data()
    return sharded_smc.sharded_batched_particle_filter(
        mesh, 11, spiral_scan_kernel(), torch.zeros(2), init_c, step_c, 1024,
        auto_batch=True, device="cpu")


CASES = [case_mesh_shapes, case_vmapped_filter, case_logsumexp,
         case_resample_across_shard_counts, case_two_process_resample,
         case_two_process_filter, case_checkpoint_resume]
