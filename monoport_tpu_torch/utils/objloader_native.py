"""ctypes binding of the repository's native OBJ parser,
``csrc/objloader.cpp`` (port of ``monoport_tpu/utils/objloader_native.py``).

``load_obj_verts(path)``: vertices only (the reference's tinyobjloader
use); ``load_obj_fast(path)``: also the fan-triangulated faces. The
library is built with ``g++`` at first use into the kernels' build
directory (``ops/cuda/build.BUILD_DIR``, the package's ``_build/``), under
a name that carries the source's hash; the repository's ``csrc/`` is only
read. Without a compiler or the source, both fall back to the port's
pure-Python reader (``utils/mesh.load_obj_mesh``). A host file parser:
nothing here touches a device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

from ..ops.cuda import build

SOURCE = os.path.abspath(os.path.join(build.PACKAGE, os.pardir, "csrc",
                                      "objloader.cpp"))

_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(build.BUILD_DIR, f"libobjloader_{digest}.so")


def _build(path: str) -> bool:
    """Compile the source into ``path`` (through a temporary file, so a
    concurrent build never loads half a library). -> success."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(path))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SOURCE],
                       check=True, capture_output=True)
        os.replace(tmp, path)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(SOURCE):
            _build_failed = True
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.obj_parse_file.restype = ctypes.c_void_p
        lib.obj_parse_file.argtypes = [ctypes.c_char_p]
        lib.obj_num_verts.restype = ctypes.c_int64
        lib.obj_num_verts.argtypes = [ctypes.c_void_p]
        lib.obj_num_faces.restype = ctypes.c_int64
        lib.obj_num_faces.argtypes = [ctypes.c_void_p]
        lib.obj_verts_ptr.restype = ctypes.POINTER(ctypes.c_float)
        lib.obj_verts_ptr.argtypes = [ctypes.c_void_p]
        lib.obj_faces_ptr.restype = ctypes.POINTER(ctypes.c_int64)
        lib.obj_faces_ptr.argtypes = [ctypes.c_void_p]
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """True iff the native parser is built and loaded."""
    return _load() is not None


def load_obj_fast(path: str):
    """-> (verts [V, 3] float32, faces [F, 3] int64); native if possible."""
    lib = _load()
    if lib is None:
        from .mesh import load_obj_mesh
        return load_obj_mesh(path)
    handle = lib.obj_parse_file(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    try:
        nv = lib.obj_num_verts(handle)
        nf = lib.obj_num_faces(handle)
        verts = np.ctypeslib.as_array(
            lib.obj_verts_ptr(handle), shape=(nv * 3,)).reshape(nv, 3).copy()
        faces = np.ctypeslib.as_array(
            lib.obj_faces_ptr(handle), shape=(nf * 3,)).reshape(nf, 3).copy()
    finally:
        lib.obj_free(handle)
    return verts, faces


def load_obj_verts(path: str) -> np.ndarray:
    """Vertices only (the tinyobjloader contract)."""
    return load_obj_fast(path)[0]
