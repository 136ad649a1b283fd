"""Kernels 1-3's share of their bytes roofline: their bytes from the
shapes over their device time a filter (by symbol) at 3.35 TB/s."""

from portbench.readers import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec, "resample")
