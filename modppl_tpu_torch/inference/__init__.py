"""Inference: the batched SMC state and fixed-order reductions."""
