"""ctypes loader for libspmv_host with lazy on-first-use compilation.

The native tier has no pybind11 dependency: it exposes a plain
C ABI consumed via ctypes. The .so is compiled once with g++ for a portable
target (no ``-march=native``) and cached under a name keyed on a hash of the
source, the compiler flags and the machine architecture, so a library built
on one host is never loaded on a host it was not built for. If no toolchain
is present everything falls back to the numpy implementations
(spmv_tpu.io.petsc, spmv_tpu.formats.ell).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "spmv_host.cpp")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]


def _so_path() -> str:
    """``<checkout>/build/native/libspmv_host-<key>.so`` when the checkout
    is writable (source checkout, `pip install -e .`), else under
    ~/.cache/spmv_tpu (regular installs land in a read-only
    site-packages). ``build/`` is git-ignored."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS + [platform.machine()]).encode())
    name = f"libspmv_host-{h.hexdigest()[:16]}.so"
    root = os.path.dirname(os.path.dirname(_HERE))
    if os.access(root, os.W_OK):
        cache = os.path.join(root, "build", "native")
    else:
        cache = os.path.join(
            os.environ.get("XDG_CACHE_HOME",
                           os.path.join(os.path.expanduser("~"), ".cache")),
            "spmv_tpu")
    return os.path.join(cache, name)


_SO = _so_path()

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=300)
        if res.returncode != 0 or not os.path.exists(tmp):
            return False
        os.replace(tmp, _SO)  # atomic: concurrent builders never see half
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.spmv_petsc_matrix_header.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
    lib.spmv_petsc_matrix_header.restype = ctypes.c_int
    lib.spmv_petsc_matrix_read_slice.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p, i64p,
    ]
    lib.spmv_petsc_matrix_read_slice.restype = ctypes.c_int
    lib.spmv_petsc_vector_header.argtypes = [ctypes.c_char_p, i64p]
    lib.spmv_petsc_vector_header.restype = ctypes.c_int
    lib.spmv_petsc_vector_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, f64p,
    ]
    lib.spmv_petsc_vector_read.restype = ctypes.c_int
    lib.spmv_pack_ell.argtypes = [
        i64p, i32p, f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        i32p, f64p,
    ]
    lib.spmv_pack_ell.restype = ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.spmv_dia_scan.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i64p, i64p, i64p,
    ]
    lib.spmv_dia_scan.restype = ctypes.c_int
    lib.spmv_dia_pack_f64.argtypes = [
        i64p, i32p, f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i64p, ctypes.c_int64, f64p,
    ]
    lib.spmv_dia_pack_f64.restype = ctypes.c_int
    lib.spmv_dia_pack_f32.argtypes = [
        i64p, i32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i64p, ctypes.c_int64, f32p,
    ]
    lib.spmv_dia_pack_f32.restype = ctypes.c_int
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.spmv_well_scan.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, i64p, i64p, i64p, i32p,
    ]
    lib.spmv_well_scan.restype = ctypes.c_int
    for name, vp, pp in (
        ("spmv_well_pack_f32_i16", f32p, i16p),
        ("spmv_well_pack_f32_i32", f32p, i32p),
        ("spmv_well_pack_f64_i16", f64p, i16p),
        ("spmv_well_pack_f64_i32", f64p, i32p),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [
            i64p, i32p, vp, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, i32p, vp, pp,
        ]
        fn.restype = ctypes.c_int
    lib.spmv_from_coo_f64.argtypes = [
        i64p, i64p, f64p, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, f64p, ctypes.c_int32]
    lib.spmv_from_coo_f64.restype = ctypes.c_int64
    lib.spmv_from_coo_f32.argtypes = [
        i64p, i64p, f32p, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, f32p, ctypes.c_int32]
    lib.spmv_from_coo_f32.restype = ctypes.c_int64
    lib.spmv_pairwise_pass.argtypes = [
        i64p, i64p, f64p, ctypes.c_int64, ctypes.c_int64, f64p, i64p]
    lib.spmv_pairwise_pass.restype = ctypes.c_int64
    lib.spmv_spgemm_f64.argtypes = [
        i64p, i32p, f64p, ctypes.c_int64,
        i64p, i32p, f64p, ctypes.c_int64,
        i64p, i32p, f64p, ctypes.c_int64]
    lib.spmv_spgemm_f64.restype = ctypes.c_int64
    lib.spmv_strongest_neighbor.argtypes = [
        i64p, i64p, f64p, f64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.spmv_strongest_neighbor.restype = ctypes.c_int
    lib.spmv_rcm_symmetrize.argtypes = [
        i64p, i32p, ctypes.c_int64, ctypes.c_int64, i64p, i32p]
    lib.spmv_rcm_symmetrize.restype = ctypes.c_int64
    lib.spmv_rcm_order.argtypes = [i64p, i32p, ctypes.c_int64, i64p]
    lib.spmv_rcm_order.restype = ctypes.c_int
    lib.spmv_permute_csr_f64.argtypes = [
        i64p, i32p, f64p, ctypes.c_int64, i64p, i64p, i32p, f64p]
    lib.spmv_permute_csr_f64.restype = ctypes.c_int
    lib.spmv_permute_csr_f32.argtypes = [
        i64p, i32p, f32p, ctypes.c_int64, i64p, i64p, i32p, f32p]
    lib.spmv_permute_csr_f32.restype = ctypes.c_int
    lib.spmv_laplace2d_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p]
    lib.spmv_laplace2d_f64.restype = ctypes.c_int
    lib.spmv_laplace2d_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p]
    lib.spmv_laplace2d_f32.restype = ctypes.c_int
    lib.spmv_laplace3d_f64.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p, i32p, f64p]
    lib.spmv_laplace3d_f64.restype = ctypes.c_int
    lib.spmv_laplace3d_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p]
    lib.spmv_laplace3d_f32.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The bound library, building it on first call; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) and not _build():
            return None
        try:
            _lib = _bind(ctypes.CDLL(_SO))
        except OSError:
            _lib = None
        return _lib


def native_available() -> bool:
    return get_lib() is not None
