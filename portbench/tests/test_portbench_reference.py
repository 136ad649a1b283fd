"""The plain references agree with the program on the CPU at a small size,
and a run whose timed path is broken underneath comes out not correct:
each fault a cell can have, planted in the program, turns ``correct``
false. The HMC control (TF32 products) exists only on the card."""

import json

import pytest
import torch

from portbench import loader
from portbench.control import control_numbers
from portbench.run import run_cell

SEED = 2 ** 31 + 911
SPIRAL = "spiral-bpf.16m-particles"
HMC = "hmc-illcond-d128.4096-chains"
SMALL = {
    SPIRAL: {"traffic": {"units": [{"particles": 1 << 13, "steps": 10}],
                         "profiled_units": 1}},
    HMC: {"traffic": {"units": [{"chains": 32, "warmup": 12, "samples": 8}],
                      "profiled_units": 1}},
}
SECONDS = {SPIRAL: 1.0, HMC: 0.5}


def small_run(cell, seed=SEED, trace=False):
    return run_cell(cell, seed, SECONDS[cell], trace, "cpu",
                    overrides=SMALL[cell])


@pytest.mark.parametrize("cell", [SPIRAL, HMC])
def test_program_agrees_with_reference(cell):
    r = small_run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == set(loader.reference(
        loader.workload(loader.benchmark(), cell)["config"])[1])


# -- faults planted in the spiral filter -------------------------------------

def _state_unchanged(monkeypatch):
    from modppl_tpu_torch.parallel import sharded_smc

    def gather(s, tree):
        n = s.shape[0]
        return tree, torch.arange(n, dtype=torch.int32, device=s.device)

    monkeypatch.setattr(sharded_smc, "gather_from_s", gather)


def _weights(monkeypatch, change):
    from modppl_tpu_torch.inference import vsmc

    step = vsmc.guided_step

    def guided(*args, **kwargs):
        trace, w, accepts, draws = step(*args, **kwargs)
        return trace, change(w.clone()), accepts, draws

    monkeypatch.setattr(vsmc, "guided_step", guided)


def _half_left_out(monkeypatch):
    def change(w):
        w[w.shape[0] // 2:] = -torch.inf
        return w

    _weights(monkeypatch, change)


def _answer_altered(monkeypatch):
    def change(w):
        w[0] += 1.0
        return w

    _weights(monkeypatch, change)


def _streams_shared(monkeypatch):
    """Half the particles draw from the other half's lane streams: every
    site's draws of slot i + N/2 are slot i's."""
    from modppl_tpu_torch.modeling import autobatch

    keys = autobatch._Particles.particle_keys

    def shared(self, addr):
        k = keys(self, addr).clone()
        h = k.shape[0] // 2
        k[k.shape[0] - h:] = k[:h]
        return k

    monkeypatch.setattr(autobatch._Particles, "particle_keys", shared)


SPIRAL_FAULTS = [_state_unchanged, _half_left_out, _answer_altered,
                 _streams_shared]


@pytest.mark.parametrize("fault", SPIRAL_FAULTS)
def test_spiral_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not small_run(SPIRAL)["correct"]


# -- faults planted in the HMC sampling kernel's wrapper ---------------------

def _chunk(monkeypatch, change):
    from modppl_tpu_torch.ops import leapfrog

    sample = leapfrog.sample_chunk

    def chunk(u, *args):
        us, lps, aps, dvs = sample(u, *args)
        return change(u, us, lps, aps, dvs)

    chunk.launches = sample.launches  # the kernel's wrapper counts here
    monkeypatch.setattr(leapfrog, "sample_chunk", chunk)


def _hmc_state_unchanged(monkeypatch):
    _chunk(monkeypatch, lambda u, us, lps, aps, dvs: (
        u[None].expand_as(us).clone(), lps, aps, dvs))


def _hmc_half_left_out(monkeypatch):
    def change(u, us, lps, aps, dvs):
        h = us.shape[1] // 2
        us, aps = us.clone(), aps.clone()
        us[:, h:], aps[:, h:] = us[:, :h], aps[:, :h]
        return us, lps, aps, dvs

    _chunk(monkeypatch, change)


def _hmc_answer_altered(monkeypatch):
    def change(u, us, lps, aps, dvs):
        aps = aps.clone()
        aps[-1, 0] = aps[-1, 0] * 0.5
        return us, lps, aps, dvs

    _chunk(monkeypatch, change)


def _hmc_warmup_half(monkeypatch):
    """Kernel 6's pooled sums over half the chains: the step size and the
    inverse mass come from a warmup of the first half alone (the second
    half warms up apart)."""
    from modppl_tpu_torch.ops import leapfrog

    warm = leapfrog.warmup_chunk

    def chunk(u0s, z, jit, u01, *args):
        h = u0s.shape[0] // 2
        halves = [warm(*(x.contiguous() for x in (
            u0s[sl], z[:, sl], jit[:, sl], u01[:, sl])), *args)
            for sl in (slice(None, h), slice(h, None))]
        return (torch.cat([halves[0][0], halves[1][0]]), halves[0][1],
                halves[0][2])

    chunk.launches = warm.launches
    monkeypatch.setattr(leapfrog, "warmup_chunk", chunk)


HMC_FAULTS = [_hmc_state_unchanged, _hmc_half_left_out, _hmc_answer_altered,
              _hmc_warmup_half]


@pytest.mark.parametrize("fault", HMC_FAULTS)
def test_hmc_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert not small_run(HMC)["correct"]


# -- the faults at the cells' own sizes, on the card -------------------------

# Kernel 6's pooled sums over half the chains fail the check at the test's
# size only: at 4096 chains they move the adapted mass by 2-3x the
# round-off spread between the program and the float64 reference, inside
# the limits, and leave the sampling phase exact (PERF.md, section 2).
CELL_FAULTS = ([(SPIRAL, f) for f in SPIRAL_FAULTS]
               + [(HMC, f) for f in HMC_FAULTS if f is not _hmc_warmup_half])


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", CELL_FAULTS,
                         ids=[f"{c.split('.')[0]}-{f.__name__.strip('_')}"
                              for c, f in CELL_FAULTS])
def test_fault_at_the_cells_size_is_not_correct_on_the_card(monkeypatch,
                                                            cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("the cells' sizes run on a CUDA device only")
    fault(monkeypatch)
    for seed in (SEED + 11, SEED + 12, SEED + 13):
        r = run_cell(cell, seed, 2.0, False, "cuda")
        print(json.dumps({"cell": cell, "fault": fault.__name__,
                          "seed": seed, "correct": r["correct"],
                          "checks": r["checks"]}), flush=True)
        assert not r["correct"], r["checks"]


# -- the controls ------------------------------------------------------------

def test_spiral_control_fails_the_check():
    nums = control_numbers(SPIRAL, SEED, units=8, device="cpu",
                           overrides=SMALL[SPIRAL])
    # the control's filter judged one by one is keyed as the program's is,
    # and bfloat16 cannot hold its states to the round-off siblings share
    assert nums["sibling_gap"][0] > nums["sibling_gap"][1], nums
    assert any(v > lim for v, lim in nums.values()), nums


@pytest.mark.card
def test_hmc_control_fails_the_check_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 products exist only on a CUDA device")
    small = {"traffic": {"units": [{"chains": 512, "warmup": 100,
                                    "samples": 32}]}}
    for seed in (SEED, SEED + 1, SEED + 2):
        nums = control_numbers(HMC, seed, device="cuda", overrides=small)
        assert any(v > lim for v, lim in nums.values()), nums
