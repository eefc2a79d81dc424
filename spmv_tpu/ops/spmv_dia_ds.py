"""Double-single (float64-class) DIA SpMV and SpMM.

Matrix and vector are carried as double-single (hi + lo float32 pairs,
spmv_tpu.ds): ~48 significand bits, rel. error ~1e-14 on stencil SpMV,
with storage and arithmetic in float32. The shifts are those of the
float32 DIA apply (ops.spmv_dia.shift_rows), run on both legs, and the
products and sums use error-free transformations (Dekker two_prod, Knuth
two_sum). ``local_format='dia_ds'`` operators apply through this module.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.ds import ds_add, ds_from_f64, ds_mul_f32, ds_to_f64
from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.formats.dia import flat_to_interleaved
from spmv_tpu.ops.spmv_dia import LANES, shift_rows


@dataclasses.dataclass
class DiaDsMatrix:
    """DIA matrix in double-single storage: two interleaved f32 planes."""

    data_hi: jax.Array  # (R/128, K*128) interleaved (DiaMatrix.data layout)
    data_lo: jax.Array
    offsets: tuple[int, ...]
    nrows: int
    ncols: int
    _nnz: int = 0

    @property
    def nrows_pad(self) -> int:
        return self.data_hi.shape[0] * LANES

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    def format_size_bytes(self) -> int:
        return 2 * self.data_hi.size * 4


jax.tree_util.register_dataclass(
    DiaDsMatrix,
    data_fields=["data_hi", "data_lo"],
    meta_fields=["offsets", "nrows", "ncols", "_nnz"],
)


def csr_to_dia_ds(a: CSRHost, row_align: int = 128, max_diags: int = 64) -> DiaDsMatrix:
    """Convert an f64 host CSR to double-single DIA storage. The split stays
    in NUMPY until upload: routing through a jax array would silently
    downcast f64 to f32 when x64 is off and zero the lo plane."""
    from spmv_tpu.formats.dia import csr_to_dia_host

    flat, offsets, nnz = csr_to_dia_host(
        a, row_align=row_align, max_diags=max_diags, dtype=np.float64
    )
    hi, lo = ds_from_f64(flat)
    k = flat.shape[0]
    return DiaDsMatrix(
        data_hi=jnp.asarray(flat_to_interleaved(hi, k)),
        data_lo=jnp.asarray(flat_to_interleaved(lo, k)),
        offsets=offsets,
        nrows=a.nrows,
        ncols=a.ncols,
        _nnz=nnz,
    )


def dia_ds_apply(data_hi, data_lo, offsets: tuple[int, ...], xh3, xl3):
    """Double-single local DIA product: (R, nrhs, 128) hi/lo legs in,
    (yh, yl) of the same shape out."""
    rows = data_hi.shape[0]
    acc_h = jnp.zeros(xh3.shape, jnp.float32)
    acc_l = jnp.zeros(xh3.shape, jnp.float32)
    for k, off in enumerate(offsets):
        dh = data_hi[:, None, k * LANES:(k + 1) * LANES]
        dl = data_lo[:, None, k * LANES:(k + 1) * LANES]
        ph, plo = ds_mul_f32(dh, dl, shift_rows(xh3, off, rows),
                             shift_rows(xl3, off, rows))
        acc_h, acc_l = ds_add(acc_h, acc_l, ph, plo)
    return acc_h, acc_l


def spmm_dia_ds_2d(
    a: DiaDsMatrix, xh2: jax.Array, xl2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Double-single block SpMM in the (rows, nrhs*128) layout (nrhs = 1
    is the single-vector lane layout): both matrix planes are read once
    for the whole block."""
    rows = xh2.shape[0]
    yh, yl = dia_ds_apply(a.data_hi, a.data_lo, a.offsets,
                          xh2.reshape(rows, -1, LANES),
                          xl2.reshape(rows, -1, LANES))
    return yh.reshape(rows, -1), yl.reshape(rows, -1)


def spmv_dia_ds_2d(
    a: DiaDsMatrix, xh2: jax.Array, xl2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Double-single SpMV in lane layout: (hi, lo) x pair -> (hi, lo) y
    pair. Rel. error ~1e-14 vs exact f64."""
    return spmm_dia_ds_2d(a, xh2, xl2)


def spmv_dia_ds(a: DiaDsMatrix, x: np.ndarray | jax.Array) -> np.ndarray:
    """Convenience: f64 vector in, f64 vector out (length nrows_pad).
    Conversions happen host-side; for hot loops keep vectors as (hi, lo)
    pairs and call spmv_dia_ds_2d directly."""
    npad = a.nrows_pad
    xv = np.zeros(npad, dtype=np.float64)
    n = min(len(x), npad)
    xv[:n] = np.asarray(x, dtype=np.float64)[:n]
    hi, lo = ds_from_f64(xv)
    yh, yl = spmv_dia_ds_2d(
        a, jnp.asarray(hi.reshape(-1, LANES)), jnp.asarray(lo.reshape(-1, LANES)),
    )
    return ds_to_f64(np.asarray(yh).reshape(-1), np.asarray(yl).reshape(-1))
