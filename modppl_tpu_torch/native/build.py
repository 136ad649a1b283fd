"""Builds the port's C extensions (``addrops.c``, ``ctrie.c``) at first use.

Each source is compiled by the host's C compiler (``$CC``, else ``gcc``)
against this Python's headers into ``modppl_tpu_torch/_build/``, never into
the source tree, under a name that carries a hash of the source, the flags
and the Python ABI (a changed source builds anew; an unchanged one is
reused). The compiler writes to a per-process temporary name that is then
renamed into place, so processes that import the package at once (test
workers) never load a half-written file. ``python -m
modppl_tpu_torch.native.build`` builds both and prints where.
"""

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent / "_build"
NAMES = ("addrops", "ctrie")
FLAGS = ("-O2", "-fPIC", "-shared")


def _compiler():
    return os.environ.get("CC", "gcc")


def library_path(name):
    """Where the extension built from ``<name>.c`` lives."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    h = hashlib.sha256(" ".join((_compiler(),) + FLAGS).encode())
    h.update(suffix.encode())
    h.update((HERE / f"{name}.c").read_bytes())
    return BUILD / f"_{name}-{h.hexdigest()[:12]}{suffix}"


def build(name):
    """Compile ``<name>.c`` unless its extension exists; returns its path.
    Raises ``RuntimeError`` with the compiler's output if it fails."""
    path = library_path(name)
    if path.exists():
        return path
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *FLAGS, f"-I{sysconfig.get_path('include')}",
           str(HERE / f"{name}.c"), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load(name):
    """The extension module ``_<name>``, built first if need be."""
    path = build(name)
    spec = importlib.util.spec_from_file_location(
        f"modppl_tpu_torch.native._{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


if __name__ == "__main__":
    for n in NAMES:
        sys.stderr.write(f"built {build(n)}\n")
