"""Block CG over the multi-RHS SpMM kernel (see solvers/block_cg.py)."""
import jax.numpy as jnp
import jax
import numpy as np
import pytest

from spmv_tpu.formats.dia import csr_to_dia
from spmv_tpu.gen import create_laplace_2d, gaussian_bump
from spmv_tpu.solvers.block_cg import block_cg_dia


@pytest.mark.parametrize("nrhs", [2, 4])
def test_block_cg_solves_all_columns(nrhs):
    a = create_laplace_2d(48, 48)
    d = csr_to_dia(a, dtype=np.float64, row_align=4096)
    rng = np.random.default_rng(nrhs)
    B = rng.standard_normal((a.nrows, nrhs))
    X, res = block_cg_dia(d, B, kmax=800, rtol=1e-10)
    assert bool(res.converged), np.asarray(res.rnorm)
    for r in range(nrhs):
        rel = np.linalg.norm(a.matvec(np.asarray(X[:, r])) - B[:, r]) \
            / np.linalg.norm(B[:, r])
        assert rel < 1e-9, (r, rel)


def test_block_cg_fewer_iterations_than_worst_column():
    """Sharing the Krylov block must not need more iterations than solving
    the hardest column alone with plain CG."""
    import jax

    from spmv_tpu.ops.spmv_dia import dia_to_2d, spmv_dia_2d
    from spmv_tpu.solvers.cg import cg

    a = create_laplace_2d(32, 32)
    d = csr_to_dia(a, dtype=np.float64, row_align=4096)
    rng = np.random.default_rng(9)
    B = np.stack([gaussian_bump(a.nrows), rng.standard_normal(a.nrows),
                  rng.standard_normal(a.nrows)], axis=1)
    X, res = block_cg_dia(d, B, kmax=800, rtol=1e-9)
    assert bool(res.converged)

    worst = 0
    for r in range(3):
        b2 = dia_to_2d(d, jnp.asarray(np.pad(B[:, r],
                                             (0, d.nrows_pad - a.nrows))))
        single = cg(lambda p: spmv_dia_2d(d, p), b2, kmax=800, rtol=1e-9)
        worst = max(worst, int(single.iterations))
    assert int(res.iterations) <= worst, (int(res.iterations), worst)


def test_block_cg_mixed_convergence_rates():
    """Columns with very different difficulty (one pre-solved) must not
    destabilize the block (rank-deficiency regularization)."""
    a = create_laplace_2d(32, 32)
    d = csr_to_dia(a, dtype=np.float64, row_align=4096)
    rng = np.random.default_rng(11)
    x_known = rng.standard_normal(a.nrows)
    B = np.stack([a.matvec(x_known) * 1e-8,  # tiny, converges instantly
                  rng.standard_normal(a.nrows)], axis=1)
    X, res = block_cg_dia(d, B, kmax=800, rtol=1e-8)
    assert bool(res.converged)
    for r in range(2):
        rel = np.linalg.norm(a.matvec(np.asarray(X[:, r])) - B[:, r]) \
            / np.linalg.norm(B[:, r])
        assert rel < 1e-7, (r, rel)


def test_block_cg_refined_f64_class():
    """fp32 block-CG inner + DS residual refinement: TRUE f64-class
    residuals for every column (the naked fp32 block solve stalls at
    kappa*eps_f32)."""
    from spmv_tpu.solvers.block_cg import block_cg_refined

    a = create_laplace_2d(48, 48)
    rng = np.random.default_rng(21)
    B = rng.standard_normal((a.nrows, 3))
    X, outer, inner, rnorms = block_cg_refined(
        a, B, rtol=1e-11, inner_kmax=2000, inner_rtol=1e-5)
    for r in range(3):
        rel = np.linalg.norm(a.matvec(X[:, r]) - B[:, r]) \
            / np.linalg.norm(B[:, r])
        assert rel < 1e-10, (r, rel)


@pytest.mark.parametrize("n_dev", [1, 4])
def test_dist_matmat_ds_matches_per_column(n_dev):
    """The DS block apply (matrix planes streamed once for all columns)
    matches per-column matvec_ds exactly."""
    from spmv_tpu.ds import ds_from_f64
    from spmv_tpu.gen import create_laplace_2d
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(40, 40)
    A = build_dist_matrix(a, n_devices=n_dev, local_format="dia_ds")
    nrhs = 3
    X = np.random.default_rng(21).standard_normal((a.nrows, nrhs))
    xh, xl = ds_from_f64(X)
    xh_d, xl_d = A.to_dist_block(xh), A.to_dist_block(xl)
    yh, yl = jax.jit(lambda M, h, l: M.matmat_ds(h, l))(A, xh_d, xl_d)
    Yh, Yl = A.from_dist_block(yh), A.from_dist_block(yl)
    for r in range(nrhs):
        ch = A.to_dist(xh[:, r].copy())
        cl = A.to_dist(xl[:, r].copy())
        vh, vl = jax.jit(lambda M, h, l: M.matvec_ds(h, l))(A, ch, cl)
        np.testing.assert_array_equal(Yh[:, r], A.from_dist(vh))
        np.testing.assert_array_equal(Yl[:, r], A.from_dist(vl))
    want = np.stack([a.matvec(X[:, r]) for r in range(nrhs)], axis=1)
    got = Yh.astype(np.float64) + Yl.astype(np.float64)
    rel = np.linalg.norm(got[:a.nrows] - want) / np.linalg.norm(want)
    assert rel < 1e-13


def test_block_cg_refined_dist_f64_class():
    """Distributed refined block CG: EVERY column of a multi-RHS solve
    reaches f64-class residuals (VERDICT r2 item 6)."""
    from spmv_tpu.gen import create_laplace_2d
    from spmv_tpu.solvers.block_cg import block_cg_refined_dist

    a = create_laplace_2d(48, 48)  # kappa ~ 1e3
    nrhs = 4
    B = np.random.default_rng(22).standard_normal((a.nrows, nrhs))
    X, outers, inners, rnorms = block_cg_refined_dist(
        a, B, n_devices=4, rtol=1e-11, inner_rtol=1e-5, inner_kmax=800)
    bnorm = np.linalg.norm(B, axis=0)
    # true residual certified in f64 on host
    R = np.stack([a.matvec(X[:, r]) for r in range(nrhs)], axis=1) - B
    rel = np.linalg.norm(R, axis=0) / bnorm
    assert np.all(rel < 1e-9), (rel, outers, inners)
    assert np.all(rnorms / bnorm < 1e-9)
