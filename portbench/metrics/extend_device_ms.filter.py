"""Device ms a filter outside kernels 1-3 (the resample's kernels, named
in ``counts/``): the extend, the lane keys and the rest, whoever wrote
their kernels."""

from portbench.readers import outside_group_ms


def read(rec):
    return outside_group_ms(rec, "resample")
