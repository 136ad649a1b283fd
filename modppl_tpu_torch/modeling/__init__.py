"""The ``@gen`` DSL, its generate handler and the batched tier."""

from modppl_tpu_torch.modeling.gen import Gen, gen

__all__ = ["Gen", "gen"]
