"""The port's spans (utils/profiling.annotate) on the filter's and the HMC
run's paths, read from a CPU profile: one span a unit, a step or a phase,
the lane words inside every extend, no copy span off the card, and the
outputs bitwise the same with the profiler on and off."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from modppl_tpu_torch.core import keys
from modppl_tpu_torch.core.trie import Trie
from modppl_tpu_torch.inference.hmc import hmc_runner
from modppl_tpu_torch.models.illcond_gauss import make_illcond_gauss
from modppl_tpu_torch.models.spiral import circle_observations, spiral_scan_kernel
from modppl_tpu_torch.parallel.sharded_smc import sharded_batched_particle_filter
from modppl_tpu_torch.utils.profiling import annotate, host_to_device
from _torch_threads import one_thread  # noqa: F401

T = 4
N = 1024


def spans(fn):
    """fn()'s result and its ``modppl.`` host spans [(name, start, end)]."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = sorted(((ev.name, ev.time_range.start, ev.time_range.end)
                    for ev in prof.events() if ev.name.startswith("modppl.")),
                   key=lambda s: (s[1], -s[2]))
    return out, found


def named(found, name):
    return [s for s in found if s[0] == name]


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def run_filter():
    obs = torch.tensor(circle_observations(T), dtype=torch.float32)
    return sharded_batched_particle_filter(
        None, 12345, spiral_scan_kernel(), torch.zeros(2), Trie.from_dict(
            {"obs": obs[0]}), Trie.from_dict({"obs": obs[1:]}), N,
        ess_threshold=1.0, auto_batch=True, device="cpu")


def hmc_run(d):
    run = hmc_runner(make_illcond_gauss(d, cond=20.0, seed=1), (), Trie(),
                     num_samples=4, num_warmup=12, num_chains=8,
                     num_leapfrog=4, device="cpu")
    return lambda: run(777)


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_the_filter_opens_a_span_a_unit_and_a_step():
    _, found = spans(run_filter)
    (unit,) = named(found, "modppl.filter")
    resamples = named(found, "modppl.resample")
    extends = named(found, "modppl.extend")
    assert len(resamples) == T - 1 and len(extends) == T
    lane_words = named(found, "modppl.lane_words")
    for s in resamples + extends + lane_words:
        assert inside(s, unit)
    for ext in extends:
        assert any(inside(w, ext) for w in lane_words)
    # the resample draws its uniform from a generator, not from lane words
    assert not any(inside(w, r) for w in lane_words for r in resamples)
    assert not named(found, "modppl.h2d")


@pytest.mark.parametrize("d", [4, 16], ids=["small_d", "large_d"])
def test_the_hmc_run_opens_a_span_a_run_and_a_phase(d):
    _, found = spans(hmc_run(d))
    (run,) = named(found, "modppl.hmc.run")
    for name in ("modppl.hmc.warmup", "modppl.hmc.sample",
                 "modppl.hmc.check"):
        (s,) = named(found, name)
        assert inside(s, run)
    warm, samp, check = (named(found, f"modppl.hmc.{n}")[0]
                         for n in ("warmup", "sample", "check"))
    assert warm[2] <= samp[1] and samp[2] <= check[1]
    assert not named(found, "modppl.h2d")


def test_the_filter_is_bitwise_the_same_under_the_profiler():
    plain = run_filter()
    traced, found = spans(run_filter)
    assert found and same(plain, traced)


@pytest.mark.parametrize("d", [4, 16], ids=["small_d", "large_d"])
def test_the_hmc_run_is_bitwise_the_same_under_the_profiler(d):
    run = hmc_run(d)
    plain = run()
    traced, found = spans(run)
    assert found and same(plain, traced)


def test_a_lane_function_opens_one_span_however_it_is_built():
    k = keys.lanes(5, 16, "cpu")
    calls = [lambda: keys.lanes(5, 16, "cpu"),
             lambda: keys.split_keys(5, 16, "cpu"),
             lambda: keys.fold_in_lanes(5, torch.arange(3)),
             lambda: keys.split_lanes(k, 3),
             lambda: keys.lane_bits(k, 4),
             lambda: keys.uniform_lanes(k, (2,)),
             lambda: keys.normal_lanes(k, (2,)),
             lambda: keys.words_at(k, torch.arange(16))]
    for call in calls:
        _, found = spans(call)
        assert [s[0] for s in found] == ["modppl.lane_words"]


def test_no_copy_span_opens_off_the_card():
    _, found = spans(lambda: (host_to_device(3, torch.int64, "cpu"),
                              host_to_device([1.0, 2.0]),
                              keys.key_lane(9, "cpu")))
    assert found == []
    assert torch.equal(host_to_device([1, 2], torch.int32, "cpu"),
                       torch.tensor([1, 2], dtype=torch.int32))


def test_a_decorated_function_opens_a_span_on_every_call():
    @annotate("modppl.test")
    def f(x):
        return x + 1

    out, found = spans(lambda: [f(torch.ones(2)) for _ in range(3)])
    assert len(found) == 3 and torch.equal(out[0], torch.full((2,), 2.0))
    # a span may nest in another of the same name
    with annotate("modppl.test"):
        assert f(1) == 2
