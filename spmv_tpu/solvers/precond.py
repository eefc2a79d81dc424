"""Preconditioners beyond the diagonal — block Jacobi.

The reference has no preconditioning at all (its CG is unpreconditioned,
reference spmv/cg.cpp:21-98). spmv_tpu already offers diagonal (Jacobi)
scaling; this module adds BLOCK Jacobi, which fits the lane layout:

  - the operator's 128x128 diagonal blocks align exactly with the vector
    lane layout (one block per lane-row of the distributed vectors);
  - the blocks are inverted ONCE at setup as a single batched
    jnp.linalg.inv over a (G, 128, 128) array;
  - the apply is one batched (G, 128, 128) @ (G, 128) matmul per
    iteration — embarrassingly parallel across shards, ZERO communication
    (block-diagonal structure never crosses the row partition because the
    partition is 128-aligned by construction).

Sequential-factorization preconditioners (ILU/IC) are deliberately absent:
their triangular solves serialize; block Jacobi is the standard
communication-free alternative at this layer.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.parallel.dist_matrix import DistMatrix
from spmv_tpu.parallel.partition import owner_ranges

LANES = 128


def block_jacobi_preconditioner(a: CSRHost, A: DistMatrix):
    """Build z = diag_blocks(A)^-1 r for ``cg``/``bicgstab``/``gmres``.

    ``a`` is the host CSR the operator was assembled from (the block
    extraction is a host-side pass over the nonzeros); ``A`` supplies the
    mesh/layout. Returns a closure over a sharded (D*G, 128, 128) inverse-
    block array. Rows with an empty/padded diagonal block get unit rows, so
    padding passes through unscaled (like the plain Jacobi closure).
    """
    nd = A.n_devices
    rp = A.row_pad
    g = rp // LANES
    ranges = owner_ranges(a.nrows, nd)

    blocks = np.zeros((nd, g, LANES, LANES), np.float64)
    lens = a.row_nnz()
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    cols = a.colind.astype(np.int64)
    shard = np.searchsorted(ranges, rows, side="right") - 1
    lr = rows - ranges[shard]          # local row within the shard
    lc = cols - ranges[shard]          # column relative to the same shard
    same = (cols >= ranges[shard]) & (cols < ranges[np.minimum(shard + 1, nd)])
    blk = lr // LANES
    in_blk = same & (lc // LANES == blk)
    np.add.at(
        blocks,
        (shard[in_blk], blk[in_blk], lr[in_blk] % LANES, lc[in_blk] % LANES),
        a.values[in_blk],
    )
    # regularize empty rows (padding, or rows with no in-block entries):
    # unit diagonal -> identity action there
    empty = np.abs(blocks).sum(axis=3) == 0  # (nd, g, 128)
    s_, g_, r_ = np.nonzero(empty)
    blocks[s_, g_, r_, r_] = 1.0

    from jax.sharding import NamedSharding, PartitionSpec as P

    dtype = A.dtype
    binv = np.linalg.inv(blocks).astype(dtype)
    binv_d = jax.device_put(
        jnp.asarray(binv.reshape(nd * g, LANES, LANES)),
        NamedSharding(A.mesh, P(A.axis_name, None, None)),
    )

    def apply(r):
        # r: (D*G, 128) lane layout -> batched block solve, no comm
        return jnp.einsum("grc,gc->gr", binv_d, r,
                          precision=jax.lax.Precision.HIGHEST)

    return apply
