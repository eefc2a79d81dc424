"""Chebyshev iteration — the reduction-free inner solver
(solvers/chebyshev.py; beyond-reference capability)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmv_tpu.solvers.chebyshev import (
    chebyshev,
    chebyshev_bounds,
    chebyshev_iterations_for,
    ChebyshevResult,
)


def _spd(n, seed, kappa=100.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    evals = np.geomspace(1.0, kappa, n)
    return (q * evals) @ q.T, 1.0, kappa


def test_chebyshev_hits_theoretical_contraction():
    dense, lmin, lmax = _spd(300, 3)
    b = np.random.default_rng(4).standard_normal(300)
    mv = lambda x: jnp.asarray(dense) @ x
    want = np.linalg.solve(dense, b)
    iters = chebyshev_iterations_for(lmax / lmin, 1e-8)
    res = jax.jit(
        lambda bb: chebyshev(mv, bb, lmin, lmax, iters)
    )(jnp.asarray(b))
    rel = np.linalg.norm(np.asarray(res.x) - want) / np.linalg.norm(want)
    # the bound is in the A-norm; allow an order of slack in the 2-norm
    assert rel < 1e-6, rel
    assert res.iterations == iters


def test_chebyshev_block_shares_matmat():
    """Multi-RHS: the recurrence is elementwise, one matmat serves the
    whole block and every column converges."""
    dense, lmin, lmax = _spd(200, 5, kappa=50.0)
    B = np.random.default_rng(6).standard_normal((200, 4))
    mm = lambda X: jnp.asarray(dense) @ X
    iters = chebyshev_iterations_for(lmax / lmin, 1e-8)
    res = jax.jit(lambda bb: chebyshev(mm, bb, lmin, lmax, iters))(
        jnp.asarray(B))
    want = np.linalg.solve(dense, B)
    rel = np.linalg.norm(np.asarray(res.x) - want) / np.linalg.norm(want)
    assert rel < 1e-6


def test_chebyshev_bounds_enclose_spectrum():
    dense, lmin, lmax = _spd(250, 7, kappa=200.0)
    mv = lambda x: jnp.asarray(dense) @ x
    v0 = jnp.asarray(np.random.default_rng(8).standard_normal(250))
    lo, hi = chebyshev_bounds(mv, v0, m=80)
    assert float(hi) >= lmax * 0.999   # safe top bound (divergence guard)
    assert float(lo) <= lmin * 1.001   # bottom bound below the spectrum


def test_refined_block_chebyshev_inner_f64_class():
    """block_cg_refined(inner_solver='chebyshev') reaches f64-class
    residuals with reduction-free inner sweeps."""
    from spmv_tpu.gen import create_laplace_2d
    from spmv_tpu.solvers.block_cg import block_cg_refined

    a = create_laplace_2d(64, 64)
    nrhs = 3
    B = np.random.default_rng(9).standard_normal((a.nrows, nrhs))
    X, outers, inners, rnorms = block_cg_refined(
        a, B, rtol=1e-11, inner_rtol=1e-4, inner_kmax=2000,
        inner_solver="chebyshev")
    bnorm = np.linalg.norm(B, axis=0)
    R = np.stack([a.matvec(X[:, r]) for r in range(nrhs)], axis=1) - B
    rel = np.linalg.norm(R, axis=0) / bnorm
    assert np.all(rel < 1e-9), (rel, outers, inners)


def test_dist_refined_chebyshev_inner_no_reductions():
    """Distributed Chebyshev inner sweeps lower to HLO with ZERO
    all-reduces — the halo ppermutes are the only collectives (a CG inner
    has >= 2 all-reduce-backed dots per iteration)."""
    from spmv_tpu.gen import create_laplace_2d
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix
    from spmv_tpu.solvers.block_cg import block_cg_refined_dist

    a = create_laplace_2d(24, 24)
    nrhs = 2
    B = np.random.default_rng(10).standard_normal((a.nrows, nrhs))
    X, outers, inners, rnorms = block_cg_refined_dist(
        a, B, n_devices=4, rtol=1e-11, inner_rtol=1e-4, inner_kmax=2000,
        inner_solver="chebyshev")
    R = np.stack([a.matvec(X[:, r]) for r in range(nrhs)], axis=1) - B
    rel = np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)
    assert np.all(rel < 1e-9), rel

    # HLO check on a standalone inner sweep
    from spmv_tpu.solvers.chebyshev import chebyshev

    A32 = build_dist_matrix(a, n_devices=4, local_format="dia",
                            dtype=np.float32)
    xb = A32.to_dist_block(
        np.random.default_rng(11).standard_normal(
            (a.nrows, nrhs)).astype(np.float32))
    txt = jax.jit(
        lambda M, v: chebyshev(M.matmat, v, 0.1, 8.0, 25).x
    ).lower(A32, xb).compile().as_text()
    assert txt.count("all-reduce") == 0, "Chebyshev sweep must be dot-free"
    assert (txt.count("collective-permute") + txt.count(
        "collective-permute-start")) > 0  # halo still present


def test_chebyshev_adaptive_corrects_bad_floor():
    """The measured kappa ~ 1e5 envelope limit (NEXT.md round 3): a
    Lanczos floor ABOVE the clustered bottom stalls plain chebyshev; the
    adaptive variant measures the rate, jumps to the rate-consistent
    bound once, and converges — no decay spiral."""
    from spmv_tpu.solvers.chebyshev import chebyshev_adaptive

    n = 2048
    rng = np.random.default_rng(0)
    ev = np.concatenate([[1e-5, 1.2e-5, 1.5e-5],
                         rng.uniform(0.3, 1.0, n - 3)]).astype(np.float32)
    A = jnp.asarray(ev)
    mv = lambda v: A * v
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    lo_bad = 6.25e-5  # the quarter-theta floor, 6x above true lambda_min

    res = jax.jit(lambda bb: chebyshev_adaptive(
        mv, bb, lo_bad, 1.0, rtol=1e-5, sweep_iters=16, max_sweeps=400))(b)
    rel = float(jnp.linalg.norm(b - mv(res.x)) / jnp.linalg.norm(b))
    assert rel < 2e-5, rel
    lmin_f = float(res.lmin_final)
    # corrected below the bad floor, but not spiraled to the clamp
    assert lmin_f < lo_bad
    assert lmin_f > 1e-9, lmin_f
    assert int(res.sweeps) < 400
    assert int(res.iterations) == int(res.sweeps) * 16


def test_chebyshev_adaptive_good_bounds_untouched():
    """With a correct enclosure the rate matches the prediction and the
    bound is never moved (no false corrections from equioscillation)."""
    from spmv_tpu.solvers.chebyshev import chebyshev_adaptive

    dense, lmin, lmax = _spd(300, 3)
    b = np.random.default_rng(4).standard_normal(300).astype(np.float32)
    mv = lambda x: jnp.asarray(dense, dtype=jnp.float32) @ x
    res = chebyshev_adaptive(mv, jnp.asarray(b), lmin * 0.9, lmax,
                             rtol=1e-6, sweep_iters=16, max_sweeps=100)
    assert float(res.lmin_final) == pytest.approx(lmin * 0.9, rel=1e-6)
    want = np.linalg.solve(dense, b)
    rel = np.linalg.norm(np.asarray(res.x) - want) / np.linalg.norm(want)
    assert rel < 1e-4, rel


def test_chebyshev_preconditioner_accelerates_cg():
    """PCG with the fixed-degree Chebyshev polynomial preconditioner:
    same true-residual convergence meaning, materially fewer OUTER
    iterations (hence fewer psums) on a stiff SPD operator."""
    from spmv_tpu.solvers.cg import cg
    from spmv_tpu.solvers.chebyshev import chebyshev_preconditioner

    dense, lmin, lmax = _spd(300, 9, kappa=2000.0)
    b = np.random.default_rng(10).standard_normal(300)
    mv = lambda x: jnp.asarray(dense) @ x
    plain = cg(mv, jnp.asarray(b), kmax=600, rtol=1e-10)
    m_inv = chebyshev_preconditioner(mv, lmin, lmax, degree=8)
    prec = cg(mv, jnp.asarray(b), kmax=600, rtol=1e-10,
              preconditioner=m_inv)
    assert bool(prec.converged)
    want = np.linalg.solve(dense, b)
    rel = np.linalg.norm(np.asarray(prec.x) - want) / np.linalg.norm(want)
    assert rel < 1e-8, rel
    # degree-8 polynomial cuts kappa_eff enough that outer iterations
    # (and with them the psum count) drop by far more than 2x
    assert int(prec.iterations) * 2 < int(plain.iterations)


def test_chebyshev_preconditioner_with_minres():
    """The polynomial is SPD on the enclosure, so PMINRES accepts it."""
    from spmv_tpu.solvers.chebyshev import chebyshev_preconditioner
    from spmv_tpu.solvers.minres import minres

    dense, lmin, lmax = _spd(200, 11, kappa=500.0)
    b = np.random.default_rng(12).standard_normal(200)
    mv = lambda x: jnp.asarray(dense) @ x
    m_inv = chebyshev_preconditioner(mv, lmin, lmax, degree=6)
    plain = minres(mv, jnp.asarray(b), kmax=600, rtol=1e-10)
    prec = minres(mv, jnp.asarray(b), kmax=600, rtol=1e-10,
                  preconditioner=m_inv)
    assert bool(prec.converged)
    want = np.linalg.solve(dense, b)
    rel = np.linalg.norm(np.asarray(prec.x) - want) / np.linalg.norm(want)
    assert rel < 1e-7, rel
    assert int(prec.iterations) < int(plain.iterations)
