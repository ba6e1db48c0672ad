"""Build and load the CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for sm_90a into a shared
library with a plain C interface under ``_build/`` and loaded with ctypes,
at first use. The library's name carries the hash of the source and the
shared headers, so an edited source never loads a stale library.
``build_all`` compiles every source at once, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

PACKAGE = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
CSRC = os.path.join(PACKAGE, "csrc")
BUILD_DIR = os.path.join(PACKAGE, "_build")
HEADERS = ("mix_rows.cuh", "mlp_tiles.cuh", "wgmma_mlp.cuh")


def sources() -> list[str]:
    """Names (no extension) of every kernel source under ``csrc/``."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    for path in (source_path(name),
                 *(os.path.join(CSRC, h) for h in HEADERS)):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def nvcc_command(source: str, library: str) -> list[str]:
    """The compiler call that builds ``source`` into ``library``; register
    and shared-memory use go to stderr."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
            library, source]


def _start(name: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(nvcc_command(source_path(name), tmp))
    return proc, tmp


def _finish(name: str, proc, tmp: str) -> str:
    try:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode})")
        path = library_path(name)
        os.replace(tmp, path)
        return path
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` -> the library's path."""
    return _finish(name, *_start(name))


def build_all(seconds: dict | None = None) -> dict[str, str]:
    """Compile every source, all compilers started together. ``seconds``
    receives each source's time from the common start to its library."""
    t0 = time.perf_counter()
    started = [(name, *_start(name)) for name in sources()]
    built, errors = {}, []
    for name, proc, tmp in started:      # wait for all, then report
        try:
            built[name] = _finish(name, proc, tmp)
        except RuntimeError as err:
            errors.append(err)
        if seconds is not None:
            seconds[name] = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return built


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    path = library_path(name)
    if not os.path.exists(path):
        build(name)
    return ctypes.CDLL(path)


def bind(name: str, function: str, argtypes: list):
    """``function`` of the library of ``csrc/<name>.cu``, returning int."""
    fn = getattr(library(name), function)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
