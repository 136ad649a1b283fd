"""Device ms a run in the operations launched inside the program's
``modppl.hmc.warmup`` and ``modppl.hmc.sample`` spans: kernels 6-7 and
their draws."""

from portbench.spans import span_ms


def read(rec):
    return span_ms(rec, ["modppl.hmc.warmup", "modppl.hmc.sample"])
