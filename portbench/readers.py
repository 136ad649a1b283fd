"""The arithmetic the metric readers share. Each takes the run's record
(``run.run_cell``): ``window_s``, ``units``, ``walls_s`` (a closed loop's
unit walls), ``event_ms`` (the traced window's CUDA-event time of each
unit), ``profile`` (``trace.Profile`` of the profiled units, or None),
``counts`` and ``peaks``, and what the cell's ``summary`` added. A reader
that finds nothing to read returns None, and the metric is left out."""

from portbench import stats


def per_unit_s(rec):
    """A unit's mean time in the traced window, from its CUDA events."""
    ev = rec.get("event_ms") or []
    return sum(ev) / len(ev) / 1e3 if ev else None


def p95_ms(rec):
    return stats.percentile(rec.get("event_ms") or [], 95)


def least_s(work, peaks):
    """The least time for ``work`` ({"bytes", "flops"}) at the card's
    peaks: the larger of the bytes' and the operations' times."""
    return max(work["bytes"] / peaks["hbm_bytes_per_s"],
               work["flops"] / peaks["fp32_flops_per_s"])


def mfu_pct(rec):
    """The whole unit's least time at the peaks over its measured time."""
    t = per_unit_s(rec)
    if not t:
        return None
    return 100.0 * least_s(rec["counts"]["unit"], rec["peaks"]) / t


def idle_pct(rec):
    prof = rec.get("profile")
    if prof is None or not prof.ops or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)


def kernel_roofline_pct(rec, group):
    """The ``group``'s kernels' least time a unit at the peaks, over their
    device time a unit in the profile (kernels matched by symbol)."""
    from portbench.trace import symbol_matcher

    prof = rec.get("profile")
    g = rec["counts"]["groups"].get(group)
    if prof is None or g is None:
        return None
    secs = prof.op_seconds(symbol_matcher(g["names"])) / prof.units
    if secs <= 0:
        return None
    return 100.0 * least_s(g, rec["peaks"]) / secs


def device_ops_per_unit(rec):
    prof = rec.get("profile")
    if prof is None or not prof.ops:
        return None
    return prof.op_count() / prof.units


def torch_ops_ms(rec):
    """Device ms a unit in operations that are not the program's own
    kernels (PyTorch's, and the libraries' it calls)."""
    from portbench.trace import program_kernels, symbol_matcher

    prof = rec.get("profile")
    if prof is None or not prof.ops:
        return None
    own = symbol_matcher(program_kernels())
    return 1e3 * prof.op_seconds(lambda op: not own(op)) / prof.units


def outside_group_ms(rec, group):
    """Device ms a unit in operations that are not the ``group``'s kernels
    (matched by the symbols ``counts`` names), whoever wrote them."""
    from portbench.trace import symbol_matcher

    prof = rec.get("profile")
    g = rec["counts"]["groups"].get(group)
    if prof is None or not prof.ops or g is None:
        return None
    inside = symbol_matcher(g["names"])
    return 1e3 * prof.op_seconds(lambda op: not inside(op)) / prof.units
