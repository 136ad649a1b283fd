"""modppl_tpu_torch: the PyTorch / CUDA port of modppl_tpu.

The sub-packages mirror ``modppl_tpu`` (``core``, ``dists``, ``modeling``,
``inference``, ``parallel``, ``ops``, ``models``, ``utils``) so every
module has an obvious counterpart in the JAX package, which stays the
reference. The port imports ``torch`` and never ``jax``.

Its hand-written CUDA kernels live in ``csrc/`` and are built by
``ops/_build.py`` at first use on a CUDA tensor, never at import. On CPU
tensors each kernel wrapper runs the kernel's plain PyTorch version
instead.
"""

from modppl_tpu_torch.core import (
    ArgDiff,
    GenFn,
    Selection,
    Trace,
    Trie,
    normalize_addr,
    select,
    split_addr,
)
from modppl_tpu_torch.dists import (
    Distribution,
    bernoulli,
    beta,
    categorical,
    gamma,
    geometric,
    mvnormal,
    normal,
    poisson,
    u01,
    uniform,
    uniform_continuous,
    uniform_discrete,
)
from modppl_tpu_torch.modeling import Gen, gen
from modppl_tpu_torch.utils import logsumexp

__version__ = "0.1.0"

__all__ = [
    # core
    "ArgDiff", "GenFn", "Selection", "Trace", "Trie",
    "normalize_addr", "select", "split_addr",
    # dists
    "Distribution", "u01", "bernoulli", "uniform_continuous", "uniform",
    "uniform_discrete", "categorical", "normal", "mvnormal", "geometric",
    "poisson", "gamma", "beta",
    # modeling
    "Gen", "gen",
    # utils
    "logsumexp",
]
