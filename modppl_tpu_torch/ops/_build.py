"""Builds the port's CUDA kernels at first use, and nothing else builds them.

Every ``*.cu`` file under ``modppl_tpu_torch/csrc/`` is compiled by its own
``nvcc`` for ``sm_90a``, all at once, and the objects are linked into ONE
shared library with a plain C interface, written to
``modppl_tpu_torch/_build/`` under a name that carries a hash of the sources
(``*.cuh`` headers included) and flags (a changed source builds anew; an
unchanged one is reused). The library is loaded with ``ctypes``. Each C entry launches on the stream it is
given and returns ``cudaGetLastError()``; ``check`` raises if that is not 0.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas=-v")


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else [])
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of modppl_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / f"libmodppl_kernels-{h.hexdigest()[:12]}.so"


def build():
    """Compile the kernels unless the library for these sources exists.

    Returns ``(path, seconds, compiler_log)``; ``seconds`` is 0.0 and the
    log empty when nothing had to be built. Raises if ``nvcc`` fails."""
    path = library_path()
    if path.exists():
        return path, 0.0, ""
    objs = BUILD / f"{path.stem}.{os.getpid()}.objs"
    objs.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = objs / f"{src.stem}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{obj.stem}.cu ({proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "".join(log))
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
         *[str(obj) for obj, _ in jobs]],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    shutil.rmtree(objs)
    return path, time.perf_counter() - t0, "".join(log)


@functools.lru_cache(maxsize=1)
def library():
    """The loaded kernel library, built first if need be."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.modppl_error_string.argtypes = [ctypes.c_int]
    lib.modppl_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def entry(name, argtypes):
    """The C entry ``name`` with its ``argtypes`` declared (pointers and the
    stream as ``c_void_p``); it returns a CUDA error code."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err, name):
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        msg = library().modppl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
