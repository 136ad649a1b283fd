"""Modeling layer: the ``@gen`` DSL, its handlers, the batched tier and
the combinators (``combinators``, ``map_combinator``, ``unfold``)."""

from modppl_tpu_torch.modeling.gen import Gen, gen
from modppl_tpu_torch.modeling.handlers import (
    GenerateHandler,
    RegenerateHandler,
    SimulateHandler,
    UpdateHandler,
    addr_subkey,
)

__all__ = [
    "Gen", "gen",
    "SimulateHandler", "GenerateHandler", "UpdateHandler", "RegenerateHandler",
    "addr_subkey",
]
