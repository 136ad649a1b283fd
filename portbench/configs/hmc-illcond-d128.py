"""Pooled-adaptation HMC on the ill-conditioned Gaussian through the
program's runner: ``inference/hmc.hmc_runner`` over
``models/illcond_gauss.make_illcond_gauss``, whose quadratic target takes
the chunk kernels (one warmup launch and one sampling launch a run).

A unit is one ``run(key)`` of the job's chains, warmup and samples, waited
for; between units, outside their walls, the benchmark takes the run's
smallest ESS over the coordinates (``stats.ess_geyer``, float64, on the
device). The correctness check judges the run ``mix.checked_index`` draws
against ``reference/hmc-illcond-d128.py``.
"""

import math

import torch

from portbench.stats import ess_geyer


class Cell:
    def __init__(self, cfg, spec, seed, device):
        from modppl_tpu_torch.core.trie import Trie
        from modppl_tpu_torch.inference.hmc import hmc_runner
        from modppl_tpu_torch.models.illcond_gauss import make_illcond_gauss

        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.model = make_illcond_gauss(cfg["dim"], cfg["condition_number"],
                                        seed=cfg["cov_seed"])
        self.make = lambda job: hmc_runner(
            self.model, (), Trie(), num_samples=job["samples"],
            num_warmup=job["warmup"], num_chains=job["chains"],
            step_size=cfg["step_size"], num_leapfrog=cfg["num_leapfrog"],
            target_accept=cfg["target_accept"], setup_key=cfg["setup_key"],
            device=device)
        self.runners = {}
        self.ess, self.kept, self.last = [], None, None

    @staticmethod
    def _sizes(job):
        return job["chains"], job["warmup"], job["samples"]

    def warm(self, job):
        """Build the job's runner (the target's detection) and run it once,
        with its ESS, so every kernel and FFT plan is ready."""
        self.runners[self._sizes(job)] = self.make(job)
        out = self.dispatch(job)
        ess_geyer(out["unconstrained"])

    def dispatch(self, job):
        return self.runners[self._sizes(job)](job["key"])

    def record(self, job, out, keep):
        self.ess.append(float(ess_geyer(out["unconstrained"]).min()))
        self.last = (job, {"step_size": out["step_size"],
                           "inv_mass": out["inv_mass"],
                           "positions": out["unconstrained"],
                           "accept_prob": out["accept_prob"]})
        if keep:
            self.kept = self.last

    def summary(self):
        failed = sum(1 for e in self.ess if not math.isfinite(e))
        return {"failed": failed, "ess": list(self.ess)}

    def check(self, ref, limits):
        job, got = self.kept or self.last
        self.runners = self.model = self.kept = self.last = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        numbers = ref.numbers(self.cfg, job, got, self.device)
        return {k: (v, limits[k]) for k, v in numbers.items()}
