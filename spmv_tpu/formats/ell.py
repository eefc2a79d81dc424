"""Padded ELLPACK device format — the plain general-sparsity format.

ELL stores a (nrows, K) rectangle of column indices and values, K = max
nnz/row (optionally rounded up for lane alignment); short rows are padded
with (col=0, val=0). A rectangle of uniform-length rows has static shapes:
SpMV becomes a dense gather + multiply + row-sum with static
shapes, instead of the reference's per-row CSR pointer chasing
(reference spmv/csr_kernels.cpp:42-50).

Padding waste is bounded for the target matrices (stencil Laplacians:
K in {3,5}); for power-law matrices use row-bucketing (future work noted in
SURVEY.md section 7 risk 2).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats.csr import CSRHost


@dataclasses.dataclass
class EllMatrix:
    """Device-resident padded ELLPACK matrix.

    colind: (nrows_pad, K) int32 — padded slots point at column 0
    values: (nrows_pad, K)       — padded slots hold 0
    diagonal: optional (nrows_pad,) dense diagonal, present iff symmetric
              storage (values then holds only the strict lower triangle)
    nrows/ncols: logical (unpadded) dimensions — static
    symmetric: whether this stores L of A = L + D + L^T — static
    """

    colind: jax.Array
    values: jax.Array
    nrows: int
    ncols: int
    symmetric: bool = False
    diagonal: jax.Array | None = None

    @property
    def k(self) -> int:
        return self.colind.shape[1]

    @property
    def nrows_pad(self) -> int:
        return self.colind.shape[0]

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz_stored(self) -> int:
        """Stored nonzeros (excludes padding; counts lower triangle only when
        symmetric — the reference accounts the same way, Matrix.cpp:443-444)."""
        return int(self._nnz)

    _nnz: int = 0

    def format_size_bytes(self) -> int:
        """Bytes of device storage, analogue of reference CSRMatrix::format_size
        (spmv/csr_matrix.cpp:73-79) — but for the padded rectangle actually held."""
        size = self.colind.size * self.colind.dtype.itemsize
        size += self.values.size * self.values.dtype.itemsize
        if self.diagonal is not None:
            size += self.diagonal.size * self.diagonal.dtype.itemsize
        return size


jax.tree_util.register_dataclass(
    EllMatrix,
    data_fields=["colind", "values", "diagonal"],
    meta_fields=["nrows", "ncols", "symmetric", "_nnz"],
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pack_ell_native(a: CSRHost, k: int, colind: np.ndarray,
                     values: np.ndarray) -> bool:
    """Pack via the C++ tier (native/spmv_host.cpp spmv_pack_ell). Returns
    False (caller falls back to numpy) when the library is unavailable or
    the inputs are not in the expected layouts."""
    import ctypes

    from spmv_tpu.native.lib import get_lib

    lib = get_lib()
    if lib is None:
        return False
    rowptr = np.ascontiguousarray(a.rowptr, dtype=np.int64)
    src_col = np.ascontiguousarray(a.colind, dtype=np.int32)
    src_val = np.ascontiguousarray(a.values, dtype=np.float64)
    if values.dtype != np.float64 or not values.flags.c_contiguous:
        return False
    rc = lib.spmv_pack_ell(
        rowptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        src_col.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        src_val.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        a.nrows, colind.shape[0], k,
        colind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return rc == 0


def csr_to_ell(
    a: CSRHost,
    row_align: int = 8,
    k_align: int = 1,
    dtype=None,
    symmetric: bool = False,
) -> EllMatrix:
    """Convert host CSR to padded ELL (vectorized numpy, then one upload).

    With ``symmetric=True``, stores only the strict lower triangle plus a
    dense diagonal — the reference's symmetric optimization
    (spmv/Matrix.cpp:337-349). ``a`` must then be structurally symmetric.
    """
    diag = None
    nnz_logical = a.nnz
    if symmetric:
        a, diag_np = a.split_lower_diag()
        nnz_logical = a.nnz  # lower-triangle count, matching Matrix.cpp:443-444
    nrows_pad = max(_round_up(a.nrows, row_align), row_align)
    lens = a.row_nnz()
    k = max(int(lens.max()) if a.nrows else 1, 1)
    k = max(_round_up(k, k_align), k_align)

    colind = np.zeros((nrows_pad, k), dtype=np.int32)
    values = np.zeros((nrows_pad, k), dtype=dtype or a.dtype)
    if a.nnz:
        packed = False
        if a.nnz > 1_000_000 and values.dtype == np.float64:
            # C++ packer (spmv_tpu.native): avoids the two nnz-sized index
            # temporaries the numpy path allocates — matters at 100M+ nnz
            packed = _pack_ell_native(a, k, colind, values)
        if not packed:
            rows = np.repeat(np.arange(a.nrows), lens)
            slot = np.arange(a.nnz) - np.repeat(a.rowptr[:-1], lens)
            colind[rows, slot] = a.colind
            values[rows, slot] = a.values

    if symmetric:
        diag = np.zeros(nrows_pad, dtype=values.dtype)
        diag[: len(diag_np)] = diag_np

    return EllMatrix(
        colind=jnp.asarray(colind),
        values=jnp.asarray(values),
        nrows=a.nrows,
        ncols=a.ncols,
        symmetric=symmetric,
        diagonal=None if diag is None else jnp.asarray(diag),
        _nnz=int(nnz_logical),
    )
