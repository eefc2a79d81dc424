"""Operator-BATCHED solves via jax.vmap — whole Krylov solves over a stack
of matrices in ONE compiled program.

A capability class the reference's architecture cannot express: its
executor/MPI design solves one system per program run
(reference demos/cg.cpp), and batching would mean processes x matrices.
Here every solver is a pure function of pytree inputs, so ``jax.vmap``
lifts it wholesale: stacked DIA data (same static offsets/shape) + stacked
right-hand sides -> stacked solutions, with the while_loop batched by XLA
(each lane masks off after ITS convergence). Parameter studies (one
operator pattern, many coefficient fields / shifts / RHS) become a single
device program.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.formats.dia import csr_to_dia
from spmv_tpu.gen import create_laplace_1d
from spmv_tpu.ops.spmv_dia import spmv_dia
from spmv_tpu.solvers.cg import cg
from spmv_tpu.solvers.lanczos import lanczos_extreme


def _dia_batch(scales, n=512):
    """One operator PATTERN (1-D Laplacian), a batch of coefficient scales:
    stacked DiaMatrix data with shared static metadata."""
    mats = []
    for s in scales:
        a = create_laplace_1d(n)
        a = CSRHost(a.rowptr, a.colind, a.values * s, a.ncols)
        mats.append(csr_to_dia(a))
    proto = mats[0]
    data = jnp.stack([m.data for m in mats])
    return dataclasses.replace(proto, data=data), [m for m in mats]


def test_vmap_spmv_matches_loop():
    scales = [0.5, 1.0, 2.0, 7.5]
    batched, singles = _dia_batch(scales, n=384)
    x = np.random.default_rng(3).standard_normal(singles[0].data.shape[-2]
                                                 * 0 + 384)
    xs = jnp.stack([jnp.asarray(np.pad(x * (i + 1),
                                       (0, singles[0].nrows_pad - 384)))
                    for i in range(len(scales))])
    ys = jax.jit(jax.vmap(spmv_dia))(batched, xs)
    for i, m in enumerate(singles):
        want = spmv_dia(m, xs[i])
        np.testing.assert_allclose(np.asarray(ys[i]), np.asarray(want),
                                   rtol=1e-12, atol=1e-14)


def test_vmap_cg_batch_of_systems():
    """Four CG solves (different operators AND rhs) in one compiled
    program match the four individual solves."""
    scales = [0.5, 1.0, 2.0, 7.5]
    batched, singles = _dia_batch(scales, n=384)
    npad = singles[0].nrows_pad
    rng = np.random.default_rng(5)
    bs = jnp.stack([jnp.asarray(np.pad(rng.standard_normal(384), (0, npad - 384)))
                    for _ in scales])

    def solve(d, b):
        return cg(lambda x: spmv_dia(d, x), b, kmax=800, rtol=1e-12)

    res = jax.jit(jax.vmap(solve))(batched, bs)
    assert bool(res.converged.all())
    for i, m in enumerate(singles):
        single = solve(m, bs[i])
        # same Krylov trajectory per lane: iteration counts match exactly
        assert int(res.iterations[i]) == int(single.iterations)
        np.testing.assert_allclose(np.asarray(res.x[i]),
                                   np.asarray(single.x),
                                   rtol=1e-9, atol=1e-11)


def test_vmap_cg_per_lane_convergence_masking():
    """Lanes converge at DIFFERENT iteration counts (kappa differs by
    lane); the batched while_loop must report per-lane counts, not run
    every lane to the max."""
    n = 256
    hard = create_laplace_1d(n, gamma=50.0)   # kappa ~ 200
    # shift the diagonal: kappa drops ~4x, CG converges in ~half the steps
    shift = np.zeros(hard.nnz)
    diag_mask = hard.colind == np.repeat(np.arange(n), np.diff(hard.rowptr))
    shift[diag_mask] = 60.0
    shifted = CSRHost(hard.rowptr, hard.colind, hard.values + shift,
                      hard.ncols)
    d0, d1 = csr_to_dia(hard), csr_to_dia(shifted)
    batched = dataclasses.replace(d0, data=jnp.stack([d0.data, d1.data]))
    npad = d0.nrows_pad
    b = jnp.asarray(np.pad(np.random.default_rng(7).standard_normal(n),
                           (0, npad - n)))
    res = jax.jit(jax.vmap(
        lambda d, bb: cg(lambda x: spmv_dia(d, x), bb, kmax=600, rtol=1e-10)
    ))(batched, jnp.stack([b, b]))
    assert bool(res.converged.all())
    assert int(res.iterations[1]) < int(res.iterations[0]) // 2


def test_vmap_lanczos_spectrum_sweep():
    """Spectrum estimates for a parameter sweep in one program: lambda_max
    scales linearly with the coefficient."""
    scales = [1.0, 3.0, 9.0]
    batched, singles = _dia_batch(scales, n=256)
    npad = singles[0].nrows_pad  # nrows_pad on the STACKED pytree reads
    #                              the batch dim — compute it pre-stack
    v0 = jnp.asarray(np.pad(np.random.default_rng(9).standard_normal(256),
                            (0, npad - 256)))
    lmin, lmax = jax.jit(jax.vmap(
        lambda d, v: lanczos_extreme(lambda x: spmv_dia(d, x), v, m=48)
    ))(batched, jnp.stack([v0] * 3))
    lmax = np.asarray(lmax)
    np.testing.assert_allclose(lmax[1] / lmax[0], 3.0, rtol=1e-6)
    np.testing.assert_allclose(lmax[2] / lmax[0], 9.0, rtol=1e-6)
