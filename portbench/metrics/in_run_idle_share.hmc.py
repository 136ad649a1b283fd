"""The share of the runs' device intervals (each ``modppl.hmc.run`` span's
first device operation to its last) with no device operation: idle inside
a run, without the benchmark's time between runs."""

from portbench.spans import idle_in_span_pct


def read(rec):
    return idle_in_span_pct(rec, "modppl.hmc.run")
