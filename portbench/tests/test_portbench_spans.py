"""The span readers' arithmetic on hand-built profiles: which device
operations a span launched, unions of nested and repeated spans, self
time, idle inside spans and the idle a span's copies open; and the
readers of the outside-in metrics unchanged by host spans."""

import contextlib

import pytest
import torch

from portbench import loader, readers, spans, trace
from portbench.trace import Profile

MS = 1e-3


def kernel(name, s, e):
    return (f"void {name}_kernel<4>(float const*)", s * MS, e * MS)


def launch(t, what="cudaLaunchKernel"):
    return (what, t * MS, (t + 0.005) * MS)


def span(name, s, e):
    return ("modppl." + name, s * MS, e * MS)


def filter_profile():
    """One filter: the host opens its spans and launches five operations
    well before the device runs them (the device trails the host).

    host   filter [0, 10]: extend [0, 4] { lane_words [0, 2] { h2d [1, 2]:
           launch a copy at 1.5 } launch k1 at 0.5, k2 at 3 }, resample
           [5, 6] { launch k3 at 5.5 }, launch k4 at 8
    device k1 [10, 12], copy [12, 13], gap, k2 [14, 20], k3 [20, 21],
           gap, k4 [22, 23]
    """
    host = [span("filter", 0, 10), span("extend", 0, 4),
            span("lane_words", 0, 2), span("h2d", 1, 2),
            launch(0.5), launch(1.5, "cudaMemcpyAsync"), launch(3),
            span("resample", 5, 6), launch(5.5), launch(8),
            ("cudaStreamSynchronize", 1.6 * MS, 12.9 * MS)]
    ops = [kernel("k1", 10, 12),
           ("Memcpy HtoD (Pageable -> Device)", 12 * MS, 13 * MS),
           kernel("k2", 14, 20), kernel("k3", 20, 21), kernel("k4", 22, 23)]
    return Profile(ops, host, units=1)


def read(name, prof):
    return loader.metric(name).read({"profile": prof})


def test_launches_pair_with_operations_in_order():
    sp = spans.Spans(filter_profile())
    assert sp.paired
    assert sp.op_ranges(["modppl.lane_words"]) == [[0, 2]]
    assert sp.op_ranges(["modppl.extend"]) == [[0, 3]]
    assert sp.op_ranges(["modppl.resample"]) == [[3, 4]]
    assert sp.device_intervals("modppl.filter") == [[10 * MS, 23 * MS]]


def test_span_device_time_self_time_and_their_sum():
    prof = filter_profile()
    # lane words: k1 (2 ms) and the copy under h2d, nested (1 ms)
    assert read("lane_words_device_ms.filter", prof) == pytest.approx(3.0)
    # the extend less its lane words: k2
    assert read("extend_self_device_ms.filter", prof) == pytest.approx(6.0)
    assert read("resample_device_ms.filter", prof) == pytest.approx(1.0)
    # with k4 (launched by the filter itself), the three add to the busy
    # time: 3 + 6 + 1 + 1
    assert prof.busy_s == pytest.approx(11 * MS)


def test_copies_and_the_idle_they_open():
    prof = filter_profile()
    assert read("h2d_copies_per_filter.filter", prof) == 1.0
    # the copy the h2d span launched runs [12, 13], the next operation
    # starts at 14: its gap counts on the device's clock alone, though the
    # device trails the host and the span closed on the host at 2
    assert read("h2d_idle_ms.filter", prof) == pytest.approx(1.0)
    # a device that keeps up: the copy ends at 1.8, and the device idles
    # until the next launch's operation at 3.2
    host = [span("filter", 0, 10), span("h2d", 1, 2),
            launch(0.5), launch(1.5, "cudaMemcpyAsync"), launch(3)]
    ops = [kernel("k1", 0.6, 0.9),
           ("Memcpy HtoD (Pageable -> Device)", 1.6 * MS, 1.8 * MS),
           kernel("k2", 3.2, 4.0)]
    fast = Profile(ops, host, units=2)
    # (the gap [0.9, 1.6] opens before the copy)
    assert read("h2d_idle_ms.filter", fast) == pytest.approx(1.4 / 2)
    assert read("h2d_copies_per_filter.filter", fast) == 0.5
    # a copy that is the profile's last operation opens no gap in it
    last = Profile(ops[:2], host[:4], units=1)
    assert read("h2d_idle_ms.filter", last) == 0.0


def test_idle_share_inside_the_filters_device_interval():
    # the filter's device interval is [10, 23]: busy 11 of 13 ms
    assert read("in_filter_idle_share.filter", filter_profile()) == \
        pytest.approx(100 * 2 / 13)


def test_nested_and_repeated_spans_count_once():
    # two runs; each a warmup and a sample span; a second, nested warmup
    # span over the same launch counts once
    host, ops = [], []
    for r in range(2):
        t = 10.0 * r
        host += [span("hmc.run", t, t + 9), span("hmc.warmup", t + 1, t + 3),
                 span("hmc.warmup", t + 1.5, t + 2.5),
                 span("hmc.sample", t + 4, t + 5),
                 span("hmc.check", t + 5.5, t + 7), launch(t + 2),
                 launch(t + 4.5), launch(t + 6)]
        ops += [kernel("warmup", t + 10, t + 14),
                kernel("sample", t + 14, t + 17),
                kernel("check", t + 17.5, t + 18)]
    prof = Profile(ops, host, units=2)
    assert read("chunk_device_ms.hmc", prof) == pytest.approx(7.0)
    assert read("check_device_ms.hmc", prof) == pytest.approx(0.5)
    # each run's interval [t + 10, t + 18] is idle 0.5 of 8 ms
    assert read("in_run_idle_share.hmc", prof) == pytest.approx(100 / 16)


def test_unpaired_launches_and_profiles_without_spans_read_nothing():
    prof = filter_profile()
    unpaired = Profile(prof.ops[:-1], prof.host, units=1)
    assert read("lane_words_device_ms.filter", unpaired) is None
    assert read("in_filter_idle_share.filter", unpaired) is None
    assert read("h2d_idle_ms.filter", unpaired) is None
    # the copies are counted from the host alone
    assert read("h2d_copies_per_filter.filter", unpaired) == 1.0
    bare = Profile(prof.ops, [h for h in prof.host
                              if not h[0].startswith("modppl.")], units=1)
    new = [m["name"] for m in loader.benchmark()["per_layer"]
           if m["source"] in ("program_span", "program_counter")]
    assert len(new) == 9
    for name in new:
        assert read(name, bare) is None
        assert loader.metric(name).read({"profile": None}) is None


def test_operations_lost_at_the_profiles_start_pair_from_the_end():
    # the first operation's record is lost: the four left pair with the
    # last four launch calls, and the spans read what the profile holds
    prof = filter_profile()
    lost = Profile(prof.ops[1:], prof.host, units=1)
    assert spans.Spans(lost).paired
    assert read("lane_words_device_ms.filter", lost) == pytest.approx(1.0)
    assert read("extend_self_device_ms.filter", lost) == pytest.approx(6.0)
    assert read("resample_device_ms.filter", lost) == pytest.approx(1.0)


def test_a_pairing_needs_matching_kinds_whatever_the_clocks():
    prof = filter_profile()
    # the copy's call made a kernel
    swapped = [prof.host[i] if prof.host[i][0] != "cudaMemcpyAsync" else
               ("cudaLaunchKernel",) + prof.host[i][1:]
               for i in range(len(prof.host))]
    assert not spans.Spans(Profile(prof.ops, swapped, units=1)).paired
    # the device's times a few ms early against the host's: the launches
    # still tell which operation each span made
    early = Profile([(n, s - 9.6 * MS, e - 9.6 * MS) for n, s, e in prof.ops],
                    prof.host, units=1)
    assert spans.Spans(early).paired
    assert read("extend_self_device_ms.filter", early) == pytest.approx(6.0)
    assert read("h2d_idle_ms.filter", early) == pytest.approx(1.0)
    # more operations than calls
    assert not spans.Spans(Profile(prof.ops + [kernel("k5", 24, 25)],
                                   prof.host, units=1)).paired


@pytest.mark.parametrize("name", [
    "cudaLaunchKernel", "cudaLaunchKernelExC_v11060", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cuMemcpyHtoDAsync_v2", "cudaMemcpy"])
def test_launch_calls(name):
    assert spans.LAUNCH.match(name)


@pytest.mark.parametrize("name", [
    "cudaStreamSynchronize", "cudaEventRecord", "cudaStreamWaitEvent",
    "cudaGetDevice", "aten::copy_", "cudaFuncGetAttributes"])
def test_calls_that_launch_nothing(name):
    assert not spans.LAUNCH.match(name)


def test_host_spans_leave_the_outside_in_readers_as_they_were():
    # the same profile without its spans; a host event opens it at the
    # spans' start, as the first filter's first operation nearly does
    prof = filter_profile()
    first = ("aten::empty", 0.0, 0.1 * MS)
    prof = Profile(prof.ops, prof.host + [first], units=1)
    bare = Profile(prof.ops, [h for h in prof.host
                              if not h[0].startswith("modppl.")], units=1)
    counts = {"groups": {"resample": {"names": ("k3_kernel",),
                                      "bytes": 1e6, "flops": 0}}}
    peaks = {"hbm_bytes_per_s": 1e12, "fp32_flops_per_s": 1e13}
    got = []
    for p in (prof, bare):
        rec = {"profile": p, "counts": counts, "peaks": peaks}
        got.append((readers.idle_pct(rec), readers.device_ops_per_unit(rec),
                    readers.torch_ops_ms(rec),
                    readers.outside_group_ms(rec, "resample"),
                    readers.kernel_roofline_pct(rec, "resample"),
                    p.top_ops(), p.busy_s, p.window_s,
                    [g[1] for g in p.idle_gaps()]))
    assert got[0] == got[1]
    # a gap that opens while the host runs Python inside a span is named
    # by the span, where it was named by the outer event open then
    assert prof.idle_gaps()[0] == ["modppl.filter", 10 * MS]
    assert bare.idle_gaps()[0] == ["aten::empty", 10 * MS]


def test_interval_arithmetic():
    a = spans.merge([(0, 2), (1, 3), (5, 6)])
    assert a == [[0, 3], [5, 6]]
    assert spans.minus(a, [[1, 2], [2.5, 5.5]]) == [[0, 1], [2, 2.5],
                                                    [5.5, 6]]
    assert spans.covered(a, [[1, 2], [2.5, 5.5]]) == pytest.approx(2.0)
    assert spans.minus(a, []) == a


@pytest.mark.card
def test_spans_add_no_device_operation_on_the_card():
    # the program's spans are host ranges: a CUDA profile of annotated work
    # holds the same device operations as one of the bare work, none under
    # a span's name, and each launch call pairs with its operation
    if not torch.cuda.is_available():
        pytest.skip("a CUDA profile needs a CUDA device")
    from modppl_tpu_torch.utils.profiling import annotate, host_to_device

    x = torch.ones(1 << 20, device="cuda")

    def work(annotated):
        opened = annotate if annotated else \
            (lambda _: contextlib.nullcontext())
        to_card = host_to_device if annotated else torch.tensor
        y = x
        with opened("modppl.filter"):
            for i in range(4):
                with opened("modppl.extend"):
                    with opened("modppl.lane_words"):
                        y = y * to_card(i + 1, device="cuda") + 1
                    y = torch.sin(y)
                with opened("modppl.resample"):
                    y = torch.cumsum(y, 0)
        torch.cuda.synchronize()

    for annotated in (False, True):
        trace.capture(lambda: work(annotated), units=1)
    bare = trace.capture(lambda: work(False), units=1)
    prof = trace.capture(lambda: work(True), units=1)
    assert not [n for n, _, _ in prof.ops if n.startswith(spans.PREFIX)]
    assert prof.op_count() == bare.op_count() > 0
    assert sorted(n for n, _, _ in prof.ops) == \
        sorted(n for n, _, _ in bare.ops)
    assert spans.Spans(prof).paired
    assert read("h2d_copies_per_filter.filter", prof) == 4.0
    assert read("h2d_idle_ms.filter", prof) >= 0.0
    # every operation lies in the extend or the resample
    parts = (read("extend_self_device_ms.filter", prof)
             + read("lane_words_device_ms.filter", prof)
             + read("resample_device_ms.filter", prof))
    assert parts == pytest.approx(1e3 * prof.op_seconds(), rel=1e-9)
