"""The program's spans in a profile, and the arithmetic the readers of
span metrics share.

A span is a host range that the program opens with
``utils/profiling.annotate``, named ``modppl.<layer>``; it reaches a
``trace.Profile`` among the host events. It makes no device event, so
the device operations a span launched are found by their launches: on one
CUDA stream the device runs its operations in the order they were
launched, so the i-th launch call of the profile (a host event such as
``cudaLaunchKernel`` or ``cudaMemcpyAsync``) made the i-th device
operation, and a span's operations are those whose launch calls lie in
its range, its nested spans' included. A profile may lose the records of
its first device operations (seen at a profile's start on the H100), so
where there are k more launch calls than operations the operations pair
with the last calls. A pairing holds when each call and its operation are
of one kind (kernel, copy, set); where none holds, the readers that need
it return None. Times are not compared across the two clocks: a profile's
device times may sit up to a millisecond off its host times.

Each reader takes the run's record (``readers``), reads its ``profile``
and returns None where the profile holds none of the spans it reads, as
a program without them gives.
"""

import bisect
import re

PREFIX = "modppl."

#: the host calls that put one operation on the device's queue
LAUNCH = re.compile(
    r"^cu(?:da)?(?:LaunchKernel(?:ExC|Ex)?|LaunchCooperativeKernel"
    r"|Memcpy(?:2D|3D)?(?:Async)?|Memset(?:D8|D16|D32)?(?:Async)?"
    r"|Memcpy[HD]to[HD](?:Async)?)(?:_v\d+|_ptsz|_ptds)?$")


def kind(name):
    """A launch call's or a device operation's kind: copy, set or kernel."""
    return ("copy" if "Memcpy" in name else "set" if "Memset" in name
            else "kernel")


def merge(intervals):
    """The union of ``intervals`` [(start, end)] as sorted, disjoint
    [start, end] pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def minus(a, b):
    """The part of the merged intervals ``a`` that the merged intervals
    ``b`` leave uncovered."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def covered(a, b):
    """The length of the merged intervals ``a`` that the merged intervals
    ``b`` cover."""
    return (sum(e - s for s, e in a)
            - sum(e - s for s, e in minus(a, b)))


class Spans:
    """A profile's spans by name and, where the launches tell, the device
    operations each launched."""

    def __init__(self, prof):
        self.units = prof.units
        self.ops = prof.ops
        self.ranges = {}
        for name, s, e in prof.host:
            if name.startswith(PREFIX):
                self.ranges.setdefault(name, []).append((s, e))
        calls = sorted((s, kind(name)) for name, s, _ in prof.host
                       if LAUNCH.match(name))
        lost = len(calls) - len(self.ops)
        calls = calls[lost:] if lost >= 0 else []
        self.launches = [s for s, _ in calls]
        #: the i-th launch call made the i-th device operation
        self.paired = bool(self.ops) and len(calls) == len(self.ops) and all(
            k == kind(op[0]) for (_, k), op in zip(calls, self.ops))
        self._cum = [0.0]
        for _, s, e in self.ops:
            self._cum.append(self._cum[-1] + (e - s))

    def has(self, name):
        return name in self.ranges

    def launched(self, name):
        """The index range [a, b) of the device operations each span of
        ``name`` launched, for those that launched any. Needs ``paired``."""
        out = []
        for s, e in self.ranges.get(name, ()):
            a = bisect.bisect_left(self.launches, s)
            b = bisect.bisect_right(self.launches, e)
            if b > a:
                out.append((a, b))
        return out

    def op_ranges(self, names):
        """The merged index ranges of the device operations launched inside
        a span of ``names`` (nested and repeated spans count once)."""
        return merge(r for name in names for r in self.launched(name))

    def op_seconds(self, index_ranges):
        return sum(self._cum[b] - self._cum[a] for a, b in index_ranges)

    def device_intervals(self, name):
        """Each span of ``name`` as the device interval from the start of
        the first operation it launched to the end of its last, merged."""
        return merge((self.ops[a][1], self.ops[b - 1][2])
                     for a, b in self.launched(name))

    def busy(self):
        return merge((s, e) for _, s, e in self.ops)


def spans_of(rec):
    prof = rec.get("profile")
    return None if prof is None else Spans(prof)


def span_ms(rec, names, less=()):
    """Device ms a unit in the operations launched inside a span of
    ``names``, less those launched inside a span of ``less``."""
    sp = spans_of(rec)
    if sp is None or not sp.paired or not any(map(sp.has, names)):
        return None
    inside = minus(sp.op_ranges(names), sp.op_ranges(less))
    return 1e3 * sp.op_seconds(inside) / sp.units


def spans_within(rec, name, unit):
    """``name``'s spans a unit that open inside a ``unit`` span, None
    where the profile holds no ``unit`` span."""
    sp = spans_of(rec)
    if sp is None or not sp.has(unit):
        return None
    units = merge(sp.ranges[unit])
    starts = [s for s, _ in units]
    n = 0
    for s, _ in sp.ranges.get(name, ()):
        i = bisect.bisect_right(starts, s) - 1
        n += i >= 0 and s < units[i][1]
    return n / sp.units


def idle_in_span_pct(rec, name):
    """The share of ``name``'s device intervals with no device operation
    running."""
    sp = spans_of(rec)
    if sp is None or not sp.paired or not sp.has(name):
        return None
    spans = sp.device_intervals(name)
    total = sum(e - s for s, e in spans)
    if total <= 0:
        return None
    return 100.0 * (1.0 - covered(spans, sp.busy()) / total)


def idle_opened_in_ms(rec, name, unit):
    """Device-idle ms a unit in the gaps that the operations launched
    inside a ``name`` span open: from the start of the first such
    operation to the start of the operation launched after the last, the
    time no operation runs. A span that waits for its copy keeps the host
    inside it until the copy has run, so the gap after the copy lasts
    until the host's next launch. None where the profile holds no ``unit``
    span or its launches do not pair."""
    sp = spans_of(rec)
    if sp is None or not sp.paired or not sp.has(unit):
        return None
    ops = sp.ops
    reach = merge((ops[a][1], ops[b][1] if b < len(ops) else ops[b - 1][2])
                  for a, b in sp.op_ranges([name]))
    idle = sum(e - s for s, e in minus(reach, sp.busy()))
    return 1e3 * idle / sp.units
