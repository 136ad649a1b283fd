"""The share of the filters' device intervals (each ``modppl.filter``
span's first device operation to its last) with no device operation:
idle inside a filter, without the time between filters."""

from portbench.spans import idle_in_span_pct


def read(rec):
    return idle_in_span_pct(rec, "modppl.filter")
