"""Device-idle ms a filter in the gaps that the copies launched inside the
program's ``modppl.h2d`` spans open, up to the next operation launched:
the idle that the copies the host waits for leave on the card."""

from portbench.spans import idle_opened_in_ms


def read(rec):
    return idle_opened_in_ms(rec, "modppl.h2d", "modppl.filter")
