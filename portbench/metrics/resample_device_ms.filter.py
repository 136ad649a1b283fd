"""Device ms a filter in the operations launched inside the program's
``modppl.resample`` spans: kernels 1-3 and the PyTorch operations around
them (the systematic uniform, the ESS, the block sums)."""

from portbench.spans import span_ms


def read(rec):
    return span_ms(rec, ["modppl.resample"])
