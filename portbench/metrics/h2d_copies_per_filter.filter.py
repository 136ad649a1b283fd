"""Copies of a host value onto the card that the host waits for, a
filter: the program's ``modppl.h2d`` spans inside its ``modppl.filter``
spans."""

from portbench.spans import spans_within


def read(rec):
    return spans_within(rec, "modppl.h2d", "modppl.filter")
