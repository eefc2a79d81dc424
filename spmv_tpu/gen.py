"""Problem generators (host side).

The analogue of the reference's matrix generator demo
(reference demos/CreateA.cpp:52-68: a 1-D 3-point operator with coupling
gamma) plus the 2-D 5-point Laplacian used for weak-scaling benchmarks
(BASELINE.md configs), and the Gaussian-bump input vector of the demos
(reference demos/spmv.cpp:63-67).
"""
from __future__ import annotations

import numpy as np

from spmv_tpu.formats.csr import CSRHost


def create_laplace_1d(n: int, gamma: float = 0.1, dtype=np.float64) -> CSRHost:
    """1-D 3-point operator: A = I + gamma * (2I - shift - shift^T).

    Tridiagonal, SPD, diagonally dominant — same family as the reference's
    CreateA demo generator (demos/CreateA.cpp:52-68 builds the gamma-coupled
    tridiagonal). Returns host CSR with rows sorted, cols ascending per row.
    """
    i = np.arange(n, dtype=np.int64)
    rows = np.concatenate([i[1:], i, i[:-1]])
    cols = np.concatenate([i[:-1], i, i[1:]])
    vals = np.concatenate(
        [
            np.full(n - 1, -gamma, dtype=dtype),
            np.full(n, 1.0 + 2.0 * gamma, dtype=dtype),
            np.full(n - 1, -gamma, dtype=dtype),
        ]
    )
    return CSRHost.from_coo(rows, cols, vals, n, n)


def _native_laplace(fill_name, dims, nnz, dtype) -> CSRHost | None:
    """Single-pass C++ stencil fill (native/spmv_host.cpp): no candidate/
    mask temporaries (the numpy builders allocate ~8 GB of them at 100M
    rows) — output arrays are written exactly once each. Returns None when
    the toolchain/dtype is unavailable (caller falls back to numpy);
    bitwise-identical to the numpy path (regression-tested)."""
    import ctypes

    from spmv_tpu.native.lib import get_lib

    np_dtype = np.dtype(dtype)
    if np_dtype == np.float64:
        suffix, cptr = "f64", ctypes.POINTER(ctypes.c_double)
    elif np_dtype == np.float32:
        suffix, cptr = "f32", ctypes.POINTER(ctypes.c_float)
    else:
        return None
    lib = get_lib()
    if lib is None:
        return None
    n = 1
    for d in dims:
        n *= d
    rowptr = np.empty(n + 1, dtype=np.int64)
    colind = np.empty(nnz, dtype=np.int32)
    values = np.empty(nnz, dtype=np_dtype)
    fn = getattr(lib, f"{fill_name}_{suffix}")
    rc = fn(*[ctypes.c_int64(d) for d in dims],
            rowptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            colind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(cptr))
    if rc != 0:
        return None
    out = CSRHost(rowptr=rowptr, colind=colind, values=values, ncols=n)
    out._sorted_unique = True
    return out


def create_laplace_2d(nx: int, ny: int | None = None, dtype=np.float64) -> CSRHost:
    """2-D 5-point Laplacian on an nx x ny grid (Dirichlet): diag 4, neighbors -1.

    SPD; the weak-scaling benchmark operator (BASELINE.md config 5: 10M-100M
    rows). Row-major grid numbering, so it is banded with offsets
    {-nx, -1, 0, +1, +nx} — ideal for the DIA fast path.

    Builds CSR directly in row order (no triplet sort) so 100M-row assembly
    stays linear-time and memory-lean (SURVEY.md section 7 risk 5); the
    native single-pass fill serves f32/f64 when the toolchain is present.
    """
    ny = ny if ny is not None else nx
    n = nx * ny
    if n > 4096:  # below this the numpy path is faster than the ctypes trip
        nat = _native_laplace("spmv_laplace2d", (nx, ny),
                              5 * n - 2 * (nx + ny), dtype)
        if nat is not None:
            return nat
    # int32 index math: n < 2^31 always holds, and the (n, 5) candidate
    # table is the dominant allocation at 100M rows (2 GB vs 4 GB)
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = idx // np.int32(nx)
    # candidate columns per row, already in ascending offset order
    offsets = np.array([-nx, -1, 0, 1, nx], dtype=np.int32)
    cand = idx[:, None] + offsets[None, :]  # (n, 5)
    valid = np.stack(
        [iy > 0, ix > 0, np.ones(n, dtype=bool), ix < nx - 1, iy < ny - 1],
        axis=1,
    )
    lens = valid.sum(axis=1).astype(np.int64)
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    colind = cand[valid]
    valmat = np.full((n, 5), -1.0, dtype=dtype)
    valmat[:, 2] = 4.0
    values = valmat[valid]
    out = CSRHost(rowptr=rowptr, colind=colind.astype(np.int32),
                  values=values, ncols=n)
    out._sorted_unique = True  # ascending-offset construction
    return out


def create_laplace_3d(nx: int, ny: int | None = None, nz: int | None = None,
                      dtype=np.float64) -> CSRHost:
    """3-D 7-point Laplacian on an nx x ny x nz grid (Dirichlet): diag 6,
    neighbors -1. Offsets {-nx*ny, -nx, -1, 0, +1, +nx, +nx*ny} — banded,
    DIA-friendly. Built directly in CSR row order (no sort); native
    single-pass fill for f32/f64 when the toolchain is present."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    n = nx * ny * nz
    if n > 4096:
        nat = _native_laplace("spmv_laplace3d", (nx, ny, nz),
                              7 * n - 2 * (nx * ny + nx * nz + ny * nz),
                              dtype)
        if nat is not None:
            return nat
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = (idx // np.int32(nx)) % np.int32(ny)
    iz = idx // np.int32(nx * ny)
    offsets = np.array([-nx * ny, -nx, -1, 0, 1, nx, nx * ny], dtype=np.int32)
    cand = idx[:, None] + offsets[None, :]
    valid = np.stack(
        [iz > 0, iy > 0, ix > 0, np.ones(n, dtype=bool),
         ix < nx - 1, iy < ny - 1, iz < nz - 1],
        axis=1,
    )
    lens = valid.sum(axis=1).astype(np.int64)
    rowptr = np.concatenate([[0], np.cumsum(lens)])
    colind = cand[valid]
    valmat = np.full((n, 7), -1.0, dtype=dtype)
    valmat[:, 3] = 6.0
    values = valmat[valid]
    out = CSRHost(rowptr=rowptr, colind=colind.astype(np.int32),
                  values=values, ncols=n)
    out._sorted_unique = True  # ascending-offset construction
    return out


def gaussian_bump(n: int, global_offset: int = 0, global_size: int | None = None,
                  dtype=np.float64) -> np.ndarray:
    """Gaussian-bump input vector over the global index space, the demo input
    (reference demos/spmv.cpp:63-67). Slicing via global_offset reproduces each
    shard's piece bit-identically."""
    gn = global_size if global_size is not None else n
    t = (np.arange(global_offset, global_offset + n, dtype=np.float64) / max(gn - 1, 1)) - 0.5
    return np.exp(-10.0 * t * t).astype(dtype)


def random_csr(
    nrows: int,
    ncols: int,
    nnz_per_row: int,
    seed: int = 0,
    dtype=np.float64,
    symmetric: bool = False,
    spd_shift: float = 0.0,
) -> CSRHost:
    """Random sparse matrix for tests (duplicates merged). With
    ``symmetric=True`` returns A + A^T (+ spd_shift * row-sum on the diagonal,
    making it strictly diagonally dominant SPD when spd_shift >= 1)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nrows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, ncols, size=nrows * nnz_per_row)
    vals = rng.standard_normal(nrows * nnz_per_row).astype(dtype)
    a = CSRHost.from_coo(rows, cols, vals, nrows, ncols)
    if symmetric:
        assert nrows == ncols
        dense_sym = a.to_dense()
        dense_sym = dense_sym + dense_sym.T
        if spd_shift:
            np.fill_diagonal(
                dense_sym,
                np.abs(dense_sym).sum(axis=1) * spd_shift + 1.0,
            )
        a = CSRHost.from_dense(dense_sym)
    return a
