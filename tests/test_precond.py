"""Block-Jacobi preconditioner (batched 128x128 block inverses;
the reference has no preconditioning at all)."""
import jax
import numpy as np
import pytest

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.gen import create_laplace_2d, gaussian_bump
from spmv_tpu.parallel.dist_matrix import build_dist_matrix
from spmv_tpu.solvers.cg import cg
from spmv_tpu.solvers.precond import block_jacobi_preconditioner


def scaled_spd(n_side, spread, seed=0):
    a0 = create_laplace_2d(n_side, n_side)
    n = a0.nrows
    w = np.logspace(-spread, spread, n)
    rng = np.random.default_rng(seed)
    w = w[rng.permutation(n)]
    rows = np.repeat(np.arange(n), a0.row_nnz())
    return CSRHost(rowptr=a0.rowptr, colind=a0.colind,
                   values=a0.values * w[rows] * w[a0.colind], ncols=n)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_block_jacobi_identity_on_padding(n_dev):
    """The preconditioned solve reaches the same solution as unpreconditioned
    CG (same operator, same rtol) — block inverses must not touch padding."""
    a = create_laplace_2d(20, 20)
    A = build_dist_matrix(a, n_devices=n_dev)
    b = gaussian_bump(a.nrows)
    M = block_jacobi_preconditioner(a, A)
    res_p = jax.jit(
        lambda A_, bb: cg(A_.as_linear_operator(), bb, kmax=300, rtol=1e-10,
                          preconditioner=M)
    )(A, A.to_dist(b))
    assert bool(res_p.converged)
    x = A.from_dist(res_p.x)
    rel = np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)
    assert rel < 1e-9, rel


def test_block_jacobi_beats_point_jacobi():
    """On a badly scaled SPD operator, 128x128 block inverses capture the
    local coupling point-Jacobi cannot: strictly fewer iterations."""
    a = scaled_spd(32, 2.0, seed=5)
    A = build_dist_matrix(a, n_devices=4)
    b = gaussian_bump(a.nrows)
    bd = A.to_dist(b)
    Mb = block_jacobi_preconditioner(a, A)
    res_block = cg(A.as_linear_operator(), bd, kmax=3000, rtol=1e-8,
                   preconditioner=Mb)
    res_point = cg(A.as_linear_operator(), bd, kmax=3000, rtol=1e-8,
                   preconditioner=A.jacobi_preconditioner())
    assert bool(res_block.converged)
    x = A.from_dist(res_block.x)
    rel = np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)
    assert rel < 1e-7, rel
    assert int(res_block.iterations) < int(res_point.iterations), (
        int(res_block.iterations), int(res_point.iterations))


def test_block_jacobi_with_gmres_nonsymmetric():
    from spmv_tpu.gen import random_csr
    from spmv_tpu.solvers.gmres import gmres

    a0 = random_csr(512, 512, 5, seed=9)
    dense = a0.to_dense()
    np.fill_diagonal(dense, np.abs(dense).sum(axis=1) + 1.0)
    a = CSRHost.from_dense(dense)
    A = build_dist_matrix(a, n_devices=2)
    b = np.random.default_rng(10).standard_normal(512)
    M = block_jacobi_preconditioner(a, A)
    res = gmres(A.as_linear_operator(), A.to_dist(b), restart=20,
                max_cycles=30, rtol=1e-10, preconditioner=M)
    assert bool(res.converged)
    x = A.from_dist(res.x, side="col")
    rel = np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b)
    assert rel < 1e-9, rel
