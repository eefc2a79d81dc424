"""s-step (communication-avoiding) GMRES: convergence parity with
restarted GMRES, distributed operation, the matrix-powers basis hookup,
and the HLO-counted reduction contract."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_spai import _convection_diffusion_2d

from spmv_tpu.gen import create_laplace_2d, gaussian_bump
from spmv_tpu.parallel.dist_matrix import build_dist_matrix
from spmv_tpu.parallel.powers import build_powers_plan, chebyshev_powers_basis
from spmv_tpu.solvers.gmres import gmres
from spmv_tpu.solvers.gmres_sstep import gmres_sstep


def test_gmres_sstep_convection_diffusion_matches_gmres():
    """Nonsymmetric convection-diffusion: CA-GMRES converges to the same
    tolerance in the same restart-cycle count as standard GMRES, and the
    solution solves the system."""
    a = _convection_diffusion_2d(20)
    A = build_dist_matrix(a, n_devices=4)
    x_true = np.random.default_rng(0).standard_normal(a.nrows)
    b_host = a.matvec(x_true)
    b = A.to_dist(b_host)
    r1 = jax.jit(
        lambda A_, bb: gmres_sstep(A_.as_linear_operator(), bb, s=4,
                                   restart=32, max_cycles=30, rtol=1e-10)
    )(A, b)
    r2 = jax.jit(
        lambda A_, bb: gmres(A_.as_linear_operator(), bb, restart=32,
                             max_cycles=30, rtol=1e-10)
    )(A, b)
    assert bool(r1.converged) and bool(r2.converged)
    assert int(r1.cycles) == int(r2.cycles)
    x = A.from_dist(r1.x)
    assert np.linalg.norm(a.matvec(x) - b_host) / np.linalg.norm(b_host) \
        < 1e-9


@pytest.mark.parametrize("n_dev,s", [(1, 2), (8, 4)])
def test_gmres_sstep_spd_case(n_dev, s):
    """On an SPD operator CA-GMRES is still GMRES — converges with a true
    residual under rtol on single and 8-device meshes."""
    a = create_laplace_2d(24, 24)
    A = build_dist_matrix(a, n_devices=n_dev)
    b_host = gaussian_bump(a.nrows)
    b = A.to_dist(b_host)
    r = jax.jit(
        lambda A_, bb: gmres_sstep(A_.as_linear_operator(), bb, s=s,
                                   restart=40, max_cycles=40, rtol=1e-8,
                                   lambda_bounds=(0.0, 8.0))
    )(A, b)
    assert bool(r.converged)
    x = A.from_dist(r.x)
    assert np.linalg.norm(a.matvec(x) - b_host) / np.linalg.norm(b_host) \
        < 1e-7


def test_gmres_sstep_mpk_basis():
    """The matrix-powers kernel supplies the block basis — one deep halo
    exchange per s Arnoldi steps — with identical convergence."""
    a = _convection_diffusion_2d(20)
    A = build_dist_matrix(a, n_devices=4)
    pp = build_powers_plan(a, A, s=4)
    x_true = np.random.default_rng(1).standard_normal(a.nrows)
    b_host = a.matvec(x_true)
    b = A.to_dist(b_host)
    r1 = jax.jit(
        lambda A_, p_, bb: gmres_sstep(
            A_.as_linear_operator(), bb, s=4, restart=32, max_cycles=30,
            rtol=1e-10,
            basis_builder=lambda q, c, e: chebyshev_powers_basis(p_, q, c, e))
    )(A, pp, b)
    assert bool(r1.converged)
    x = A.from_dist(r1.x)
    assert np.linalg.norm(a.matvec(x) - b_host) / np.linalg.norm(b_host) \
        < 1e-9


def test_gmres_sstep_fewer_reductions_in_hlo():
    """The communication contract: the CA block body carries 4 fused
    all-reduces per s=4 Arnoldi steps vs standard GMRES's 3 per step —
    at least a 2x reduction-count cut in the compiled while bodies."""
    a = create_laplace_2d(32, 32)
    A = build_dist_matrix(a, n_devices=8)
    b = A.to_dist(gaussian_bump(a.nrows))

    def body_allreduces(fn, args):
        hlo = jax.jit(fn).lower(*args).compile().as_text()
        return len([
            m for m in re.finditer(r".*all-reduce(?:-start)?\(.*", hlo)
            if "while" in m.group(0) and "body" in m.group(0)
        ])

    n_ca = body_allreduces(
        lambda A_, bb: gmres_sstep(A_.as_linear_operator(), bb, s=4,
                                   restart=16, max_cycles=2, rtol=1e-30,
                                   lambda_bounds=(0.0, 8.0)), (A, b))
    n_std = body_allreduces(
        lambda A_, bb: gmres(A_.as_linear_operator(), bb, restart=16,
                             max_cycles=2, rtol=1e-30), (A, b))
    # per-iteration: CA has 4/s = 1, standard has 3 (two CGS2 passes +
    # the norm); the bodies have different granularity (block vs step),
    # so compare per-iteration rates
    rate_ca = n_ca / 4  # block body = 4 iterations
    rate_std = n_std    # step body = 1 iteration
    assert rate_ca * 2 <= rate_std, (n_ca, n_std)


def test_gmres_sstep_restart_and_warm_resume():
    """Multi-cycle restarts make progress, and resuming from a saved x
    continues the solve (the gmres warm-resume contract)."""
    a = _convection_diffusion_2d(16)
    A = build_dist_matrix(a, n_devices=2)
    x_true = np.random.default_rng(2).standard_normal(a.nrows)
    b_host = a.matvec(x_true)
    b = A.to_dist(b_host)
    run = jax.jit(
        lambda A_, bb, x0_, mc: gmres_sstep(
            A_.as_linear_operator(), bb, x0=x0_, s=2, restart=8,
            max_cycles=mc, rtol=1e-10),
        static_argnums=3)
    r_half = run(A, b, jnp.zeros_like(b), 2)
    assert float(r_half.rnorm) < float(r_half.rnorm0)
    r_rest = run(A, b, r_half.x, 40)
    assert bool(r_rest.converged)
    x = A.from_dist(r_rest.x)
    assert np.linalg.norm(a.matvec(x) - b_host) / np.linalg.norm(b_host) \
        < 1e-9


def test_gmres_sstep_spai_right_preconditioned():
    """Preconditioning composes by OPERATOR COMPOSITION (the right-
    preconditioned system A M u = b, x = M u): pass matvec = A ∘ M and
    post-apply M — zero extra reductions, the CA structure untouched.
    With SPAI it converges in fewer iterations than unpreconditioned."""
    from spmv_tpu.solvers.spai import spai_setup

    a = _convection_diffusion_2d(20)
    m_host = spai_setup(a)
    A = build_dist_matrix(a, n_devices=4)
    Mp = build_dist_matrix(m_host, n_devices=4)
    x_true = np.random.default_rng(3).standard_normal(a.nrows)
    b_host = a.matvec(x_true)
    b = A.to_dist(b_host)

    r1 = jax.jit(
        lambda A_, M_, bb: gmres_sstep(
            lambda v: A_.matvec(M_.matvec(v)), bb, s=4, restart=32,
            max_cycles=30, rtol=1e-10)
    )(A, Mp, b)
    x = A.from_dist(Mp.matvec(r1.x))  # x = M u
    assert bool(r1.converged)
    assert np.linalg.norm(a.matvec(np.asarray(x)) - b_host) \
        / np.linalg.norm(b_host) < 1e-9
    r0 = jax.jit(
        lambda A_, bb: gmres_sstep(A_.as_linear_operator(), bb, s=4,
                                   restart=32, max_cycles=30, rtol=1e-10)
    )(A, b)
    assert int(r1.iterations) < int(r0.iterations)


def test_gmres_sstep_ill_conditioned_basis():
    """A deliberately BAD basis interval (0, 0.5) on a spectrum reaching 8
    makes the Chebyshev columns grow ~62x per step (~1e7 block condition
    at s=4) — the regime CholQR2 exists for. Convergence must survive it;
    this pins the L_total = L1 @ L2 factor order (the reversed product is
    O(1) wrong exactly when L2 deviates from identity)."""
    a = create_laplace_2d(24, 24)
    A = build_dist_matrix(a, n_devices=4)
    b_host = gaussian_bump(a.nrows)
    b = A.to_dist(b_host)
    r = jax.jit(
        lambda A_, bb: gmres_sstep(A_.as_linear_operator(), bb, s=4,
                                   restart=40, max_cycles=40, rtol=1e-8,
                                   lambda_bounds=(0.0, 0.5))
    )(A, b)
    assert bool(r.converged)
    x = A.from_dist(r.x)
    assert np.linalg.norm(a.matvec(x) - b_host) / np.linalg.norm(b_host) \
        < 1e-7


def test_powers_dia_window_pallas_aligned():
    """The DIA powers window is aligned to whole 128-lane rows, the layout
    its apply reshapes into."""
    from spmv_tpu.ops.spmv_dia import LANES

    a = create_laplace_2d(24, 24)
    A = build_dist_matrix(a, n_devices=4, local_format="dia")
    pp = build_powers_plan(a, A, s=3)
    assert pp.local_format == "dia"
    assert pp.dia_rows % LANES == 0


def test_gmres_sstep_validation():
    b = jnp.ones((8,))
    with pytest.raises(ValueError, match="s must be"):
        gmres_sstep(lambda v: v, b, s=0)
    with pytest.raises(ValueError, match="complex"):
        gmres_sstep(lambda v: v, jnp.ones((8,), jnp.complex64), s=2)
