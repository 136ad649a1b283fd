"""The port's native (C) host components (counterpart of
modppl_tpu/native/).

``addrops``: the address layer (memoized split / normalize / components /
``addr_hash``), which core/address.py's functions are. ``ctrie``: the
choice-map node core, ``CTrieBase``, which core/trie.py's ``Trie``
subclasses. Both are compiled from this directory's C sources at first
import (native/build.py) into ``modppl_tpu_torch/_build/``.

``HAVE_NATIVE`` and ``HAVE_NATIVE_TRIE`` say whether they built and
loaded. A build or load that fails keeps its error in ``BUILD_ERROR``, and
core/address.py and core/trie.py, so the package, then raise ImportError
with it: the port has one address layer and one trie core, and
``core.trie.PureTrie`` (a pure-Python node core) is only their parity
oracle.
"""

addrops = None
ctrie = None
BUILD_ERROR = None

try:
    from modppl_tpu_torch.native import build as _build

    addrops = _build.load("addrops")
    ctrie = _build.load("ctrie")
except Exception as err:  # noqa: BLE001 - kept, and raised by core/
    addrops = ctrie = None
    BUILD_ERROR = f"{type(err).__name__}: {err}"

HAVE_NATIVE = addrops is not None
HAVE_NATIVE_TRIE = ctrie is not None


def require(module, what):
    """``module`` if it built, else ImportError naming ``what`` and the
    build's error."""
    if module is None:
        raise ImportError(f"modppl_tpu_torch: the native {what} did not "
                          f"build or load: {BUILD_ERROR}")
    return module
