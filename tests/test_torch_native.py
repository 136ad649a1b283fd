"""The port's native address layer (modppl_tpu_torch/native/addrops.c):
its first-use build into the git-ignored ``_build/``, parity with the
reference's pure-Python address functions (``addr_hash`` bitwise, on the
reference test's hard addresses and on generated ones), its cache, and a
failed build stopping the import with its error. Counterpart of
tests/test_native.py."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from modppl_tpu.core import address as R
from modppl_tpu_torch import native
from modppl_tpu_torch.core import address as A
from modppl_tpu_torch.native import build
from _torch_threads import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

HARD = [
    "test",
    "(tuple, test)",
    "1/2",
    " 1/ 21f23/432 / 132  /   (  y?A1 , grexxy )   ",
    "1/   21f23  / 432/132 / (  y?A1 , grexxy ) ",
    "coeffs/a",
    "ys / 3",
    "a / b / c / d / e",
    "",
    "  spaced  ",
    "trailing/",
    "/leading",
    # the Python rule's corners: its regex's '.' stops at a newline and
    # its '$' leaves out one final newline; str.strip() trims every
    # Unicode space
    "a\n/b",
    "a/b\n",
    "a/b\n\n",
    "a/b\nc/d",
    "a/\n",
    " x / y\x1c",
    "été / café",
]


def test_build_native():
    """``python -m modppl_tpu_torch.native.build`` builds both extensions
    into ``modppl_tpu_torch/_build/`` (git-ignored), never beside the
    sources."""
    r = subprocess.run([sys.executable, "-m", "modppl_tpu_torch.native.build"],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr
    for name in build.NAMES:
        path = build.library_path(name)
        assert path.exists() and path.parent.name == "_build"
        assert str(path) in r.stderr
    assert "modppl_tpu_torch/_build/" in (REPO / ".gitignore").read_text()
    assert not list((REPO / "modppl_tpu_torch" / "native").glob("*.so"))


def test_native_is_active_here():
    assert native.HAVE_NATIVE and native.HAVE_NATIVE_TRIE, native.BUILD_ERROR
    assert native.BUILD_ERROR is None
    assert A.addr_hash is native.addrops.addr_hash


def _parity(addr):
    assert native.addrops.split_addr(addr) == R._py_split_addr(addr), addr
    assert native.addrops.normalize_addr(addr) == \
        R._py_normalize_addr(addr), addr
    assert native.addrops.addr_components(addr) == R._py_components(addr), addr
    assert native.addrops.addr_hash(addr) == R._py_addr_hash(addr), addr


@pytest.mark.parametrize("addr", HARD)
def test_native_python_parity(addr):
    _parity(addr)


@settings(max_examples=300, deadline=None)
@given(st.text(alphabet=st.sampled_from(
    list("ab /\n\t\r xyz09_()?,") + [" ", " ", "\x1c", "\x85",
                                      "é", "\U0001f600"]),
    max_size=24))
def test_native_python_parity_generated(addr):
    _parity(addr)


@settings(max_examples=200, deadline=None)
@given(st.text(max_size=16))
def test_addr_hash_bitwise_on_any_text(addr):
    """The lane keys of every site are fold_in_lanes(keys, addr_hash(addr)):
    a mismatch would change every lane draw."""
    assert native.addrops.addr_hash(addr) == R._py_addr_hash(addr)


def test_native_cache_grows():
    before = native.addrops.cache_size()
    native.addrops.addr_hash(f"unique-{before}-address/x")
    assert native.addrops.cache_size() == before + 1
    native.addrops.addr_hash(f"unique-{before}-address/x")
    assert native.addrops.cache_size() == before + 1
    with pytest.raises(TypeError, match="must be str"):
        native.addrops.addr_hash(3)


def _probe(env):
    code = ("import sys\n"
            "try:\n"
            "    from modppl_tpu_torch.core import trie\n"
            "except ImportError as err:\n"
            "    print('ImportError', err); sys.exit(0)\n"
            "from modppl_tpu_torch import native\n"
            "print(native.HAVE_NATIVE, native.HAVE_NATIVE_TRIE, "
            "trie.Trie.__mro__[2].__name__, native.BUILD_ERROR)")
    return subprocess.run([sys.executable, "-W", "always", "-c", code],
                          capture_output=True, text=True, cwd=REPO,
                          env={**os.environ, **env})


def test_switch_off_and_a_failed_build_are_reported():
    """No switch turns the native path off (MODPPL_TORCH_NATIVE=0 in the
    environment changes nothing), and a compiler that fails stops the
    import with an ImportError that carries its error."""
    off = _probe({"MODPPL_TORCH_NATIVE": "0"})
    assert off.returncode == 0, off.stderr
    assert off.stdout.split() == ["True", "True", "CTrieBase", "None"]
    bad = _probe({"CC": "false"})
    assert bad.returncode == 0, bad.stderr
    assert bad.stdout.startswith("ImportError modppl_tpu_torch: the native "
                                 "address layer did not build or load: "
                                 "RuntimeError: false ")
    assert "failed" in bad.stdout
