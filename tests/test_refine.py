"""Mixed-precision iterative refinement: f64-class solves from fp32 CG.

Beyond-reference capability (the reference only has plain double CG): the
fp32 residual floor is ~1e-7; refinement with double-single residuals
reaches ~1e-12+ TRUE f64 residual while all hot compute stays fp32.
"""
import numpy as np
import pytest

from spmv_tpu.gen import create_laplace_2d, gaussian_bump
from spmv_tpu.solvers.refine import cg_refined


def test_refinement_reaches_f64_class_residual():
    a = create_laplace_2d(48, 48)
    b = gaussian_bump(a.nrows)
    res = cg_refined(a, b, rtol=1e-12, inner_kmax=2000)
    assert res.converged
    rel = np.linalg.norm(a.matvec(res.x) - b) / np.linalg.norm(b)
    assert rel < 1e-11, rel
    # monotone contraction ~inner_rtol per outer pass
    assert res.history[1] < res.history[0] * 1e-3
    assert res.outer_iterations <= 4


def test_refinement_beats_pure_fp32_floor():
    """A single fp32 solve cannot go below ~1e-7 relative residual; the
    refined solve must land orders of magnitude lower."""
    import jax
    import jax.numpy as jnp

    from spmv_tpu.formats.dia import csr_to_dia
    from spmv_tpu.ops.spmv_dia import spmv_dia
    from spmv_tpu.solvers.cg import cg

    a = create_laplace_2d(48, 48)
    b = gaussian_bump(a.nrows)

    d32 = csr_to_dia(a, row_align=1024, dtype=np.float32)
    b32 = jnp.asarray(np.pad(b, (0, d32.nrows_pad - a.nrows)).astype(np.float32))
    res32 = cg(lambda p: spmv_dia(d32, p), b32,
               kmax=4000, rtol=1e-14)
    rel32 = np.linalg.norm(
        a.matvec(np.asarray(res32.x, np.float64)[: a.nrows]) - b
    ) / np.linalg.norm(b)

    ref = cg_refined(a, b, rtol=1e-12, inner_kmax=2000)
    rel_ref = np.linalg.norm(a.matvec(ref.x) - b) / np.linalg.norm(b)
    assert rel32 > 1e-9          # the fp32 floor is real
    assert rel_ref < rel32 / 100  # refinement breaks through it


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_distributed_ds_matvec(n_dev):
    """Sharded double-single SpMV (DS halo + DS kernel/XLA fallback) matches
    the f64 oracle to f64-class accuracy."""
    import jax
    from spmv_tpu.ds import ds_from_f64, ds_to_f64
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(48, 48)
    rng = np.random.default_rng(0)
    a.values[:] = a.values * (1 + 1e-9 * rng.standard_normal(a.nnz))
    A = build_dist_matrix(a, n_devices=n_dev, local_format="dia_ds")
    x = rng.standard_normal(a.nrows) * 1e3
    xh, xl = ds_from_f64(x)
    yh, yl = jax.jit(lambda A_, h, l: A_.matvec_ds(h, l))(
        A, A.to_dist(xh.astype(np.float32)), A.to_dist(xl.astype(np.float32))
    )
    got = ds_to_f64(A.from_dist(yh), A.from_dist(yl))
    want = a.matvec(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


@pytest.mark.parametrize("n_dev", [2, 8])
def test_distributed_refinement(n_dev):
    from spmv_tpu.solvers.refine import cg_refined_dist

    a = create_laplace_2d(48, 48)
    b = gaussian_bump(a.nrows)
    res = cg_refined_dist(a, b, n_devices=n_dev, rtol=1e-12, inner_kmax=2000)
    assert res.converged
    rel = np.linalg.norm(a.matvec(res.x) - b) / np.linalg.norm(b)
    assert rel < 1e-11, rel


def test_dia_ds_rejects_plain_matvec():
    import jax
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(48, 48)
    A = build_dist_matrix(a, n_devices=2, local_format="dia_ds")
    with pytest.raises(ValueError, match="matvec_ds"):
        A.matvec(A.to_dist(gaussian_bump(a.nrows).astype(np.float32)))


def test_distributed_ds_matvec_two_tier():
    """DS halo exchange rides the two-tier (dcn, ici) plan unchanged."""
    import jax
    from jax.sharding import Mesh
    from spmv_tpu.ds import ds_from_f64, ds_to_f64
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(48, 48)
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    A = build_dist_matrix(a, mesh=Mesh(devs, ("dcn", "ici")),
                          local_format="dia_ds")
    x = np.random.default_rng(1).standard_normal(a.nrows)
    xh, xl = ds_from_f64(x)
    yh, yl = jax.jit(lambda A_, h, l: A_.matvec_ds(h, l))(
        A, A.to_dist(xh.astype(np.float32)), A.to_dist(xl.astype(np.float32))
    )
    got = ds_to_f64(A.from_dist(yh), A.from_dist(yl))
    want = a.matvec(x)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-13


@pytest.mark.parametrize("n_dev", [2, 4])
def test_distributed_refinement_general_sparsity(n_dev):
    """f64-class distributed solves for GENERAL (non-banded) SPD matrices:
    inner fp32 WELL CG + double-single WELL residuals."""
    from spmv_tpu.formats.csr import CSRHost
    from spmv_tpu.solvers.refine import cg_refined_dist

    # random SPD: graph Laplacian of a random sparse pattern + mass term
    rng = np.random.default_rng(5)
    n = 400
    er = rng.integers(0, n, 2400)
    ec = rng.integers(0, n, 2400)
    keep = er != ec
    er, ec = er[keep], ec[keep]
    w = 0.5 + rng.random(len(er))
    deg = np.zeros(n)
    np.add.at(deg, er, w)
    np.add.at(deg, ec, w)
    a = CSRHost.from_coo(
        np.concatenate([er, ec, np.arange(n)]),
        np.concatenate([ec, er, np.arange(n)]),
        np.concatenate([-w, -w, deg + 0.05]),
        n, n,
    )
    b = rng.standard_normal(n)
    res = cg_refined_dist(a, b, n_devices=n_dev, rtol=1e-12,
                          inner_kmax=3000, local_format="well")
    rel = np.linalg.norm(a.matvec(res.x) - b) / np.linalg.norm(b)
    assert rel < 1e-10, rel


def test_refinement_jacobi_inner():
    """Jacobi-scaled inner solves on a badly diagonally-scaled SPD operator:
    same f64-class floor, strictly fewer inner iterations."""
    from spmv_tpu.formats.csr import CSRHost

    a0 = create_laplace_2d(48, 48)
    n = a0.nrows
    # D^1/2 A D^1/2 keeps SPD but spreads the diagonal over ~6 orders
    w = np.logspace(-3, 3, n)
    lens = a0.row_nnz()
    rows = np.repeat(np.arange(n), lens)
    vals = a0.values * w[rows] * w[a0.colind]
    a = CSRHost(rowptr=a0.rowptr, colind=a0.colind, values=vals, ncols=n)
    b = gaussian_bump(n)
    plain = cg_refined(a, b, rtol=1e-10, inner_kmax=4000, max_outer=8)
    jac = cg_refined(a, b, rtol=1e-10, inner_kmax=4000, max_outer=8,
                     jacobi=True)
    rel = np.linalg.norm(a.matvec(jac.x) - b) / np.linalg.norm(b)
    assert rel < 1e-9, rel
    assert jac.inner_iterations < plain.inner_iterations, (
        jac.inner_iterations, plain.inner_iterations)


def test_distributed_refinement_jacobi():
    """cg_refined_dist(jacobi=True) on a badly diagonally-scaled SPD
    operator: f64-class floor with fewer inner iterations than unscaled."""
    from spmv_tpu.formats.csr import CSRHost
    from spmv_tpu.solvers.refine import cg_refined_dist

    a0 = create_laplace_2d(48, 48)
    n = a0.nrows
    w = np.logspace(-2, 2, n)
    rows = np.repeat(np.arange(n), a0.row_nnz())
    a = CSRHost(rowptr=a0.rowptr, colind=a0.colind,
                values=a0.values * w[rows] * w[a0.colind], ncols=n)
    b = gaussian_bump(n)
    plain = cg_refined_dist(a, b, n_devices=4, rtol=1e-10, inner_kmax=4000)
    jac = cg_refined_dist(a, b, n_devices=4, rtol=1e-10, inner_kmax=4000,
                          jacobi=True)
    rel = np.linalg.norm(a.matvec(jac.x) - b) / np.linalg.norm(b)
    assert rel < 1e-9, rel
    assert jac.inner_iterations < plain.inner_iterations


def test_distributed_refinement_amg_inner():
    """cg_refined_dist(amg=True): AMG-preconditioned fp32 inner solves —
    f64-class TRUE residual at optimal-order inner iteration counts. The
    motivating wall: a plain fp32 PCG's true residual is floored at
    ~eps_f32 * |A| |x| (storing x in f32 perturbs A x by that much), so
    recursive 1e-6 convergence at 128^2 leaves a ~1e-4-class true
    residual while refinement contracts to the DS floor."""
    from spmv_tpu.solvers.refine import cg_refined_dist

    a = create_laplace_2d(128, 128, dtype=np.float32)
    a.values *= np.float32(1 / 9)
    n = a.nrows
    b = gaussian_bump(n)
    res = cg_refined_dist(a, b, n_devices=4, rtol=1e-11, inner_kmax=200,
                          amg=True)
    rel = np.linalg.norm(a.matvec(res.x) - b) / np.linalg.norm(b)
    assert rel < 1e-10, rel
    # optimal-order inner: AMG-PCG takes ~10-15 iterations per outer pass
    # (vs hundreds for plain fp32 CG at this size)
    assert res.inner_iterations <= 20 * res.outer_iterations, (
        res.inner_iterations, res.outer_iterations)
    jac = cg_refined_dist(a, b, n_devices=4, rtol=1e-11, inner_kmax=2000,
                          jacobi=True)
    assert res.inner_iterations < jac.inner_iterations


def test_distributed_refinement_amg_dict_config():
    """amg=dict passes through to amg_setup (explicit config)."""
    from spmv_tpu.solvers.refine import cg_refined_dist

    a = create_laplace_2d(40, 40, dtype=np.float32)
    a.values *= np.float32(1 / 9)
    b = gaussian_bump(a.nrows)
    res = cg_refined_dist(
        a, b, n_devices=2, rtol=1e-11, inner_kmax=200,
        amg=dict(aggregate="interval2d", interval_size=4, cycle=2,
                 local_format="dia"))
    rel = np.linalg.norm(a.matvec(res.x) - b) / np.linalg.norm(b)
    assert rel < 1e-10, rel
