"""The harness finds each part by name, and each metric's arithmetic is
right on a synthetic record."""

import math

import numpy as np
import pytest
import torch

from portbench import loader, mix, readers, stats
from portbench.trace import Profile, program_kernels, symbol_matcher

BENCH = loader.benchmark()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_parts_by_name(w):
    cfg, cell_module = loader.config(w["config"])
    assert cfg["name"] == w["config"] and hasattr(cell_module, "Cell")
    spec = loader.traffic(w["name"])
    mix.check_mix(spec)
    ref, limits = loader.reference(w["config"])
    assert callable(ref.numbers) and callable(ref.control_numbers) and limits
    counts = loader.counts(w["config"]).counts(cfg, spec)
    assert counts["unit"]["bytes"] > 0 and counts["unit"]["flops"] > 0
    for kind in ("end_to_end", "per_layer"):
        names = [m["name"] for m in loader.metrics_for(BENCH, w["name"], kind)]
        assert names
        for name in names:
            assert callable(loader.metric(name).read)
    assert "setup_s" in [m["name"] for m in
                         loader.metrics_for(BENCH, w["name"], "end_to_end")]


def test_every_metric_has_a_reader_and_names_a_layer_and_a_moved_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(loader.metric(m["name"]).read)
        assert m["moves"] in e2e and m["layer"]
    for m in BENCH["end_to_end"]:
        assert callable(loader.metric(m["name"]).read)


def test_jobs_repeat_for_a_seed_and_differ_between_seeds():
    spec = {"loop": "open", "units": [{"n": 1}, {"n": 2}, {"n": 3}]}
    a = [next(g) for g in [mix.jobs(spec, 2 ** 31 + 5)] for _ in range(6)]
    b = [next(g) for g in [mix.jobs(spec, 2 ** 31 + 5)] for _ in range(6)]
    c = [next(g) for g in [mix.jobs(spec, 7)] for _ in range(6)]
    assert a == b and [j["key"] for j in a] != [j["key"] for j in c]
    # every seed sends the same units, in the file's order
    assert [j["n"] for j in a] == [j["n"] for j in c] == [1, 2, 3] * 2
    assert 0 <= mix.checked_index(2 ** 31 + 5) < mix.CHECKED_AMONG
    warm = mix.warm_jobs(spec, 7)
    assert {j["key"] for j in warm}.isdisjoint(j["key"] for j in c)


def test_rates():
    rec = {"window_s": 2.0, "work": {"particle_steps": 3.0e9},
           "ess": [100.0, 300.0], "walls_s": [0.5, 1.5], "setup_s": 12.5}
    assert loader.metric("particle_steps_per_s").read(rec) == 1.5e9
    assert loader.metric("min_ess_per_s").read(rec) == 200.0
    assert loader.metric("setup_s").read(rec) == 12.5
    assert loader.metric("min_ess_per_s").read({"ess": [], "walls_s": []}) \
        is None


def test_p95_interpolates_between_ranks():
    xs = list(range(1, 101))  # 1..100
    assert stats.percentile(xs, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([], 95) is None
    rec = {"event_ms": [float(x) for x in xs]}
    assert loader.metric("filter_ms_p95.filter").read(rec) == \
        pytest.approx(95.05)


def synthetic_profile():
    # two units; the device runs kernel 3 for 1 ms and a PyTorch op for
    # 3 ms a unit, idle 1 ms after each unit; a host op spans the gaps
    ops, host = [], []
    for u in range(2):
        t = u * 5e-3
        ops.append(("void (anonymous namespace)::resample_from_s_kernel"
                    "<2>(int const*, float const*)", t, t + 1e-3))
        ops.append(("void at::native::vectorized_elementwise_kernel<4>()",
                    t + 1e-3, t + 4e-3))
        host.append(("aten::add", t + 4e-3, t + 5e-3))
    return Profile(ops, host, units=2)


def test_idle_share_busy_and_breakdown():
    prof = synthetic_profile()
    assert prof.window_s == pytest.approx(10e-3)
    assert prof.busy_s == pytest.approx(8e-3)
    rec = {"profile": prof}
    assert readers.idle_pct(rec) == pytest.approx(20.0)
    assert loader.metric("device_ops_per_filter.filter").read(rec) == 2.0
    top = prof.top_ops()
    assert top[0][1] == pytest.approx(6e-3)
    gaps = prof.idle_gaps()
    assert len(gaps) == 2 and gaps[0][0] == "aten::add"
    assert gaps[0][1] == pytest.approx(1e-3)


def test_roofline_mfu_and_torch_ops_on_counts():
    prof = synthetic_profile()
    peaks = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e13}
    rec = {"profile": prof, "peaks": peaks, "event_ms": [5.0, 5.0],
           "counts": {"unit": {"bytes": 1e9, "flops": 5e9},
                      "groups": {"resample": {
                          "names": ("resample_from_s_kernel",),
                          "bytes": 5e8, "flops": 0}}}}
    # 5e8 B at 1e12 B/s = 0.5 ms over 1 ms of the kernel a unit
    assert readers.kernel_roofline_pct(rec, "resample") == pytest.approx(50)
    assert readers.kernel_roofline_pct(rec, "chunk") is None
    # the unit: max(1 ms of bytes, 0.5 ms of flops) over 5 ms
    assert readers.mfu_pct(rec) == pytest.approx(20.0)
    assert readers.torch_ops_ms(rec) == pytest.approx(3.0)
    assert loader.metric("extend_device_ms.filter").read(rec) == \
        pytest.approx(3.0)


def test_extend_time_counts_every_kernel_outside_the_resample():
    # a unit: kernel 3 for 1 ms, a kernel of the program's own sources for
    # 2 ms and a PyTorch op for 3 ms; the extend's time keeps the program's
    # kernel, the PyTorch ops' time does not
    ops = [("void resample_from_s_kernel<2>(int const*)", 0.0, 1e-3),
           ("void sample_kernel<32>(float const*, float*)", 1e-3, 3e-3),
           ("void at::native::vectorized_elementwise_kernel<4>()", 3e-3,
            6e-3)]
    rec = {"profile": Profile(ops, [], units=1),
           "counts": {"groups": {"resample": {
               "names": ("resample_from_s_kernel",), "bytes": 1.0,
               "flops": 0}}}}
    assert readers.outside_group_ms(rec, "resample") == pytest.approx(5.0)
    assert readers.torch_ops_ms(rec) == pytest.approx(3.0)
    assert readers.outside_group_ms({**rec, "profile": None},
                                    "resample") is None


def test_symbols_match_the_programs_kernels_only():
    names = program_kernels()
    assert {"stats_cumsum_kernel", "positions_cummax_kernel",
            "resample_from_s_kernel", "warmup_kernel",
            "sample_kernel"} <= names
    own = symbol_matcher(names)
    assert own("void sample_kernel<32>(float const*, float*)")
    assert own("stats_cumsum_kernel(float const*, float const*)")
    assert not own("void at::native::vectorized_elementwise_kernel<4, "
                   "at::native::AUnaryFunctor<long, long, long>>(int)")
    assert not symbol_matcher(["sample_kernel"])(
        "void sample_small_kernel<3>(float const*)")


def test_spiral_counts():
    c = loader.counts("spiral-bpf").filter_counts(1 << 20, 10)
    n = 1 << 20
    assert c["bytes"] == n * (12 + 9 * 24 + 4)
    assert c["flops"] == 105 * n * 10
    # kernels 1-3 at 2^20 a launch: 8, 8 and 24 bytes a particle (+ blocks)
    nb = 1024
    assert c["groups"]["resample"]["bytes"] == 9 * (
        4 * (2 * n + 2 * nb) + 4 * (2 * n + 2 * nb + 2) + 24 * n)


def test_hmc_counts():
    c = loader.counts("hmc-illcond-d128").run_counts(128, 4096, 32, 300, 256)
    per = 33 * 2 * 128 * 128 + 4 * 128 + 7 * 128 * 32
    assert c["flops"] == 556 * 4096 * per
    assert c["flops"] / 6.7e13 == pytest.approx(0.0377, rel=1e-2)


def test_ess_matches_the_ports_geyer_estimator():
    from modppl_tpu_torch.utils.diagnostics import ess_autocorr

    rng = np.random.default_rng(3)
    chains, draws, dims = 6, 200, 5
    x = np.zeros((chains, draws, dims))
    phi = np.linspace(0.0, 0.95, dims)
    for t in range(1, draws):
        x[:, t] = phi * x[:, t - 1] + rng.standard_normal((chains, dims))
    got = stats.ess_geyer(torch.from_numpy(x), block=2).numpy()
    want = np.array([ess_autocorr(x[:, :, j]) for j in range(dims)])
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert math.isfinite(float(got.min()))


def test_an_idle_gap_is_named_by_the_innermost_host_event_open_at_its_start():
    prof = Profile([("k", 0.0, 1.0), ("k", 3.0, 4.0)],
                   [("zz_outer", 0.5, 3.5), ("aa_inner", 0.9, 1.2),
                    ("later", 1.5, 2.5)], units=1)
    assert prof.idle_gaps() == [["aa_inner", 2.0]]
