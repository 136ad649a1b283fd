"""Cases of tests/test_torch_sharded_mcmc.py, run on every rank of a
spawned gloo group (tests/_torch_dist.py): the pooled sums and warmup
across shards, ``shardmap_hmc``, ``shardmap_chees``, ``sharded_hmc`` and
NUTS with ``axis_name``, at dp = 1, 2 and the world's size. Each case
returns rank 0's view, the per-chain outputs gathered in shard order."""

import torch
import torch.distributed as dist

from modppl_tpu_torch.core import Trie
from modppl_tpu_torch.dists import iid, normal
from modppl_tpu_torch.inference import adaptation
from modppl_tpu_torch.inference.hmc import (
    _lane_draws,
    flat_target,
    hmc_transition,
)
from modppl_tpu_torch.inference.nuts import nuts_runner
from modppl_tpu_torch.modeling import gen
from modppl_tpu_torch.parallel import distributed
from modppl_tpu_torch.parallel.mesh import make_mesh

F64 = torch.float64
_MESHES = {}


def meshes():
    """dp = 1 (rank 0), 2 (ranks 0-1) and world, made once in the same
    order on every rank."""
    if not _MESHES:
        world = dist.get_world_size()
        _MESHES.update({1: make_mesh(dp=1, ranks=[0]),
                        2: make_mesh(dp=2, ranks=[0, 1]),
                        world: make_mesh(dp=world)})
    return _MESHES


def each_mesh(dps, fn):
    """``fn(mesh)``'s dict of tensors at every dp of ``dps`` this rank is
    in, keyed ``dp<k>/<name>``."""
    res = {}
    for dp in dps:
        mesh = meshes()[dp]
        if mesh.member:
            res.update({f"dp{dp}/{k}": v.numpy()
                        for k, v in fn(mesh).items()})
    return res


ys4 = iid(normal, 4)


@gen
def target(h):
    """tests/test_pooled_adaptation.py:32-38's anisotropic target."""
    mu = h.sample(normal, (0.0, 3.0), "mu")
    tau = h.sample(normal, (0.0, 0.1), "tau")
    h.sample(ys4, (mu + tau, 1.0), "ys")
    return mu


def target_obs():
    return Trie.from_dict({"ys": torch.tensor([0.4, 0.6, 0.5, 0.7],
                                              dtype=F64)})


@gen
def conjugate(h):
    """tests/test_sharded.py:122-125's model."""
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 1.0), "x")


@gen
def conjugate_half(h):
    """tests/test_chees.py:86-90's model."""
    mu = h.sample(normal, (0.0, 1.0), "mu")
    h.sample(normal, (mu, 0.5), "x")
    return mu


def x_obs():
    return Trie.from_dict({"x": torch.tensor(1.0, dtype=F64)})


def _chains(mesh, out):
    return {k: mesh.gather(out[k]) for k in ("unconstrained", "accept_prob")}


def case_pooled_sum(inputs):
    x = torch.from_numpy(inputs["x"])

    def one(mesh):
        with mesh:
            return {"sum": adaptation._pooled_sum(x[mesh.local(x.shape[0])],
                                                  "dp")}

    return each_mesh((1, 2, dist.get_world_size()), one)


def case_pooled_warmup(inputs):
    """tests/test_pooled_adaptation.py:78-110: ``run_warmup_pooled`` with
    an HMC transition (8 leapfrog steps), 16 chains, 60 iterations; a
    shard's chains draw by their global index."""
    tr, _ = target.generate(0, (), target_obs(), device="cpu")
    tgt = flat_target(target, (), tr, target_obs(), device="cpu")
    logp = torch.func.vmap(tgt.logprob)
    grad = torch.func.vmap(torch.func.grad(tgt.logprob))
    u0s = torch.from_numpy(inputs["u0s"])

    def one(mesh):
        sl = mesh.local(u0s.shape[0])

        def trans(k, us, eps, inv_mass):
            draws = _lane_draws(k, us.shape[0], us.shape[1], us.dtype,
                                us.device, offset=sl.start)
            u, _, ap, _ = hmc_transition(None, us, logp, grad, eps, 8,
                                         inv_mass, draws=draws)
            return u, ap

        with mesh:
            us, eps, inv_mass = adaptation.run_warmup_pooled(
                2, u0s[sl], trans, 60, 0.1, axis_name="dp",
                batched_transition=True)
            return {"us": mesh.gather(us), "eps": eps, "inv_mass": inv_mass}

    return each_mesh((1, dist.get_world_size()), one)


def case_shardmap_hmc(_):
    """tests/test_pooled_adaptation.py:61-75 at dp = 1 and world."""
    def one(mesh):
        out = distributed.shardmap_hmc(
            mesh, 7, target, (), target_obs(), num_samples=20, num_warmup=60,
            num_chains=16, step_size=0.1, num_leapfrog=8, device="cpu")
        return {"step_size": out["step_size"], "inv_mass": out["inv_mass"],
                **_chains(mesh, out)}

    return each_mesh((1, dist.get_world_size()), one)


def case_two_process_hmc(_):
    """tests/test_multiprocess.py's second case (tests/_mp_worker.py:20-78):
    pooled HMC on the conjugate model, 8 chains, 30 + 4, L = 3, at dp = 2
    and dp = 1."""
    def one(mesh):
        out = distributed.shardmap_hmc(
            mesh, 123, conjugate, (), x_obs(), num_samples=4, num_warmup=30,
            num_chains=8, step_size=0.1, num_leapfrog=3, device="cpu")
        return {"step_size": out["step_size"], **_chains(mesh, out)}

    return each_mesh((1, 2), one)


def case_shardmap_chees(_):
    """tests/test_chees.py:77-106 at dp = 1 and world."""
    def one(mesh):
        out = distributed.shardmap_chees(
            mesh, 4, conjugate_half, (), x_obs(), num_samples=30,
            num_warmup=60, num_chains=16, step_size=0.2, device="cpu")
        return {"step_size": out["step_size"],
                "trajectory_length": out["trajectory_length"],
                "num_leapfrog": out["num_leapfrog"], **_chains(mesh, out)}

    return each_mesh((1, dist.get_world_size()), one)


def case_sharded_hmc(_):
    """tests/test_sharded.py:115-131: 64 chains, 200 + 200, over the
    world's shards."""
    mesh = meshes()[dist.get_world_size()]
    out = distributed.sharded_hmc(mesh, 6, conjugate, (), x_obs(),
                                  num_samples=200, num_warmup=200,
                                  num_chains=64, device="cpu")
    return {"mu": mesh.gather(out["samples"]["mu"]).numpy()}


def case_nuts(_):
    """NUTS with ``axis_name``: 16 pooled chains, 20 + 10, max depth 4,
    at dp = 1 and world."""
    def one(mesh):
        run = nuts_runner(conjugate, (), x_obs(), num_chains=16,
                          num_warmup=20, num_samples=10, max_depth=4,
                          axis_name="dp", device="cpu")
        with mesh:
            out = run(5)
        return {"step_size": out["step_size"], **_chains(mesh, out)}

    return each_mesh((1, dist.get_world_size()), one)


CASES = [case_pooled_sum, case_pooled_warmup, case_shardmap_hmc,
         case_two_process_hmc, case_shardmap_chees, case_sharded_hmc,
         case_nuts]
