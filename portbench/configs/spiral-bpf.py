"""The spiral bootstrap particle filter through the program's sharded
filter on one device: ``parallel/sharded_smc.sharded_batched_particle_filter``
over ``models/spiral.spiral_scan_kernel``, float32, systematic resampling
every step, the ancestry not stored.

A unit is one filter of the job's particles and steps, keyed by the job's
key. Its log-ML and ESS stay on the device until the window has closed;
the correctness check judges them, and the final state and log-weights of
the job ``mix.checked_index`` draws, against ``reference/spiral-bpf.py``.
"""

import math

import torch


class Cell:
    def __init__(self, cfg, spec, seed, device):
        from modppl_tpu_torch.core.trie import Trie
        from modppl_tpu_torch.models.spiral import spiral_scan_kernel
        from modppl_tpu_torch.parallel.sharded_smc import (
            sharded_batched_particle_filter,
        )

        self.cfg, self.spec, self.seed, self.device = cfg, spec, seed, device
        self.filter = sharded_batched_particle_filter
        self.kernel = spiral_scan_kernel()
        self.trie = Trie
        self.state0 = torch.zeros(2, dtype=torch.float32, device=device)
        self.constraints = {}
        self.outputs = []      # (sizes, log_ml, ess) a filter, on the device
        self.kept = self.last = None
        self.work = 0

    def _constraints(self, steps):
        """The observations as the filter's (init, per-step) constraints:
        points on the circle, worked out here from the configuration."""
        if steps not in self.constraints:
            t = torch.arange(steps, dtype=torch.float64)
            ang = 2.0 * math.pi * t / self.cfg["obs_per_turn"]
            obs = (self.cfg["obs_radius"]
                   * torch.stack([torch.cos(ang), torch.sin(ang)], 1))
            obs = obs.to(torch.float32).to(self.device)
            self.constraints[steps] = (self.trie.from_dict({"obs": obs[0]}),
                                       self.trie.from_dict({"obs": obs[1:]}))
        return self.constraints[steps]

    def warm(self, job):
        self.dispatch(job)

    def dispatch(self, job):
        init_c, step_c = self._constraints(job["steps"])
        return self.filter(
            None, job["key"], self.kernel, self.state0, init_c, step_c,
            job["particles"], ess_threshold=self.cfg["ess_threshold"],
            auto_batch=self.cfg["auto_batch"],
            store_ancestry=self.cfg["store_ancestry"], device=self.device)

    def record(self, job, out, keep):
        sizes = (job["particles"], job["steps"])
        self.outputs.append((sizes, out["log_ml"], out["ess"]))
        self.work += job["particles"] * job["steps"]
        final = (job, out["state"], out["log_weights"])
        if keep:
            self.kept = final
        self.last = final

    def summary(self):
        lml = torch.stack([o[1] for o in self.outputs]).double().cpu()
        return {"failed": int((~torch.isfinite(lml)).sum()),
                "work": {"particle_steps": self.work}}

    def check(self, ref, limits):
        job, state, log_weights = self.kept or self.last
        sizes = (job["particles"], job["steps"])
        same = [o for o in self.outputs if o[0] == sizes]
        lml = torch.stack([o[1] for o in same]).double()
        ess = torch.stack([o[2] for o in same]).double()
        # the program's state goes before the reference runs
        self.filter = self.kernel = self.constraints = self.outputs = None
        self.last = self.kept = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        window = (lml, ess, [(job["key"], state, log_weights)])
        numbers = ref.numbers(self.cfg, job, self.seed,
                              self.spec["reference_units"], window,
                              self.device)
        return {k: (v, limits[k]) for k, v in numbers.items()}
