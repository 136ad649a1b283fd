"""Kernels 6-7's share of their FP32 roofline: the operations the
gradients and adaptation need, from the shapes, over their device time a
run (by symbol) at 67 TFLOP/s."""

from portbench.readers import kernel_roofline_pct


def read(rec):
    return kernel_roofline_pct(rec, "chunk")
