"""Device ms a run in the operations launched inside the program's
``modppl.hmc.check`` span: the fused path's self-check, its re-scores and
their Cholesky and solves."""

from portbench.spans import span_ms


def read(rec):
    return span_ms(rec, ["modppl.hmc.check"])
