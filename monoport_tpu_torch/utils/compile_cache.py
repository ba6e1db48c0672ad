"""Persistent kernel build directory (the port's counterpart of
``monoport_tpu/utils/compile_cache.py``, the XLA persistent cache).

The port's compiled programs are the kernel libraries that
``ops/cuda/build.py`` makes with ``nvcc`` at first use. Their names carry
the hash of their sources, so a directory that persists across runs lets a
later run load them instead of compiling again. ``enable`` points the
build at such a directory: the explicit argument, else ``DEFAULT_DIR``
(the package's ``_build/``, listed in ``.gitignore``).

Not enabled at import: the entry points (``apps/train_*``,
``apps/rtl_main``) call ``enable()`` themselves, as the JAX package's do.
"""

from __future__ import annotations

import os

from ..ops.cuda import build

DEFAULT_DIR = os.path.abspath(build.BUILD_DIR)


def enable(cache_dir: str | None = None) -> str:
    """Build and load the kernel libraries in ``cache_dir`` (default
    ``DEFAULT_DIR``) from now on. -> the directory."""
    path = os.path.abspath(cache_dir or DEFAULT_DIR)
    build.BUILD_DIR = path
    return path
