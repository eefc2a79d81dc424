"""Chebyshev iteration — the reduction-free inner solver.

Every Krylov method in this library pays per-iteration global reductions
(dots -> psum across the mesh); at pod scale those collectives are the
latency floor of the whole solve (the reference pays 3 MPI_Allreduce per
CG iteration, reference spmv/cg.cpp:49,65,75; ``cg_pipelined`` gets that
to 1). Chebyshev iteration on an SPD operator with spectrum enclosed in
[lmin, lmax] needs ZERO reductions: the step scalars come from the
recurrence, not from dots, so a distributed Chebyshev sweep is matvec +
axpy only — the halo exchange is the ONLY communication. It is also
immune to the fp32 conjugacy decay that limits long CG/block-CG inner
solves (solvers/block_cg.py): the recurrence never feeds rounding errors
back through orthogonality assumptions.

The price is needing spectrum bounds. ``lanczos_extreme_with_bounds``
(solvers/lanczos.py) supplies them: Ritz theta_max UNDERestimates
lambda_max (Cauchy interlacing), so the enclosure inflates it by its Ritz
residual plus a margin — modes outside [lmin, lmax] are AMPLIFIED by the
Chebyshev polynomial, so the top bound must be safe; a too-small lmin
only slows convergence (and theta_min >= lambda_min always, so it is
deflated by the same logic).

Converges like CG asymptotically (factor (sqrt(kappa)-1)/(sqrt(kappa)+1)
per sweep step) without sharing CG's minimax optimality on clustered
spectra — as an INNER solver for mixed-precision refinement
(block_cg_refined(inner_solver="chebyshev")): fixed iteration count,
fixed cost, no collectives, no decay.

Measured envelope: at kappa ~ 1e3 the Chebyshev inner reaches
the same f64-class refinement floor as CG; at kappa ~ 1e5 a 48-step
Lanczos cannot certify the clustered bottom of the spectrum, the
quarter-theta floor lands above lambda_min, and refinement STALLS SAFELY
(the outer stall detector returns the honest partial residual) — there
CG remains the right inner default. Use Chebyshev when bounds are known
(or kappa is modest) and collective latency dominates — e.g. pod-scale
meshes where each CG dot is a cross-slice psum.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from spmv_tpu.utils.precision import highest_precision


@dataclasses.dataclass
class ChebyshevResult:
    x: jax.Array
    iterations: int


jax.tree_util.register_dataclass(
    ChebyshevResult, data_fields=["x"], meta_fields=["iterations"],
)


@highest_precision
def chebyshev(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    lmin: float | jax.Array,
    lmax: float | jax.Array,
    iters: int,
    x0: jax.Array | None = None,
) -> ChebyshevResult:
    """``iters`` Chebyshev steps on SPD A with spectrum in [lmin, lmax].
    ``b`` may be a single vector or a multi-RHS block — the recurrence is
    elementwise, so one shared ``matvec``/``matmat`` serves any width.
    ZERO reductions; exactly ``iters`` + (0 if x0 is None else 1) operator
    applications."""
    dt = b.dtype
    theta = ((jnp.asarray(lmax) + jnp.asarray(lmin)) / 2).astype(dt)
    delta = ((jnp.asarray(lmax) - jnp.asarray(lmin)) / 2).astype(dt)
    sigma = theta / delta
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)

    d0 = r / theta
    rho0 = 1.0 / sigma

    def body(_, carry):
        x, r, d, rho_old = carry
        x = x + d
        r = r - matvec(d)
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = (rho * rho_old) * d + (2.0 * rho / delta) * r
        return (x, r, d, rho)

    x, _r, _d, _ = jax.lax.fori_loop(
        0, iters, body, (x, r, d0, rho0.astype(dt))
    )
    return ChebyshevResult(x=x, iterations=iters)


@highest_precision
def chebyshev_bounds(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    m: int = 32,
    safety: float = 1.1,
) -> tuple[jax.Array, jax.Array]:
    """Safe spectrum enclosure [lmin, lmax] for ``chebyshev`` from an
    m-step Lanczos run: lmax inflated by its Ritz residual and ``safety``
    (an UNDERestimated top bound diverges); lmin deflated likewise (a
    too-small bottom bound merely slows convergence)."""
    from spmv_tpu.solvers.lanczos import lanczos_extreme_with_bounds

    lmin, lmax, err_min, err_max = lanczos_extreme_with_bounds(
        matvec, v0, m=m)
    hi = (lmax + err_max) * safety
    # bottom: Ritz-residual deflation when it converged, a PROPORTIONAL
    # quarter-theta floor when it did not (theta_min - err can collapse to
    # ~0 on clustered spectra, which would balloon the iteration count to
    # uselessness; theta_min/4 trades a 2x iteration factor for a bound
    # that is below lambda_min whenever theta_min is within 4x of it —
    # and the refinement outer loop's stall detector catches the rare
    # matrix where it is not)
    lo = jnp.maximum(lmin - err_min, lmin * 0.25) / safety
    return jnp.maximum(lo, hi * 1e-12), hi


def chebyshev_preconditioner(
    matvec: Callable[[jax.Array], jax.Array],
    lmin: float | jax.Array,
    lmax: float | jax.Array,
    degree: int = 8,
) -> Callable[[jax.Array], jax.Array]:
    """Polynomial preconditioner: M^-1 r = p_degree(A) r, the ``degree``-step
    Chebyshev approximation of A^-1 on [lmin, lmax].

    Communication shape is the point (the reason polynomial preconditioning
    exists at pod scale): one M^-1 apply costs ``degree`` operator
    applications and ZERO global reductions, so preconditioned CG/MINRES
    keep their 2-3 psums per OUTER iteration while the effective condition
    number drops by the polynomial's clustering. The fixed-degree Chebyshev
    polynomial is symmetric positive definite on operators with spectrum in
    [lmin, lmax] (p is positive there), so it is a valid PCG/PMINRES
    preconditioner — unlike truncated *adaptive* schemes, whose iteration-
    dependent operator breaks the Krylov recurrences.

    Bounds from ``chebyshev_bounds``; degree 4-16 is the useful range
    (beyond that, spending the applies in the Krylov method itself wins).
    """
    def apply(r: jax.Array) -> jax.Array:
        return chebyshev(matvec, r, lmin, lmax, degree).x

    return apply


def chebyshev_iterations_for(kappa: float, rtol: float) -> int:
    """Iteration count for a target contraction ``rtol`` given a condition
    bound: error_k <= 2 * ((sqrt(k)-1)/(sqrt(k)+1))**k_steps."""
    import math

    kappa = max(float(kappa), 1.0 + 1e-12)
    r = (math.sqrt(kappa) - 1.0) / (math.sqrt(kappa) + 1.0)
    if r <= 0:
        return 1
    return max(1, int(math.ceil(math.log(rtol / 2.0) / math.log(r))))


@dataclasses.dataclass
class ChebyshevAdaptiveResult:
    x: jax.Array
    rnorm: jax.Array      # final true-recurrence residual norm (fro)
    lmin_final: jax.Array  # the bottom bound after stall corrections
    sweeps: jax.Array      # outer sweeps executed
    sweep_iters: int = 0   # static: steps per sweep

    @property
    def iterations(self):
        """Total operator applications (sweeps * sweep_iters) — the
        ChebyshevResult-compatible accounting the refinement drivers read."""
        return self.sweeps * self.sweep_iters


jax.tree_util.register_dataclass(
    ChebyshevAdaptiveResult,
    data_fields=["x", "rnorm", "lmin_final", "sweeps"],
    meta_fields=["sweep_iters"],
)


@highest_precision
def chebyshev_adaptive(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    lmin: float | jax.Array,
    lmax: float | jax.Array,
    rtol: float = 1e-6,
    sweep_iters: int = 16,
    max_sweeps: int = 64,
    check_every: int = 4,
    grace: int = 4,
    slack: float = 1.5,
    safety: float = 0.25,
    x0: jax.Array | None = None,
) -> ChebyshevAdaptiveResult:
    """Chebyshev iteration with RATE-CONSISTENT bottom-bound correction —
    the fix for the measured kappa ~ 1e5 envelope limit (NEXT.md
    round-3): when the Lanczos floor lands ABOVE the true lambda_min
    (clustered bottom a 48-step run cannot certify), plain ``chebyshev``
    damps the uncovered modes only at the slow outside-the-interval rate
    and refinement effectively stalls. No matvec-only method can certify
    lambda_min, so instead of certifying, MEASURE: the recurrence runs
    continuously; every ``sweep_iters`` steps ONE residual-norm
    reduction is paid (amortized 1/sweep_iters collectives per step, vs
    CG's 3 and cg_pipelined's 1). Every ``check_every`` sweeps the
    per-step contraction rho_hat observed since the last correction is
    compared with the assumed asymptotic rate
    q = (sqrt(kappa)-1)/(sqrt(kappa)+1); markedly worse (beyond the
    ``slack``-th root) means spectrum below ``lmin``. The correction
    JUMPS to the rate-consistent bound — rho_hat is itself the Chebyshev
    rate of the effective condition number, so
    lmin <- safety * lmax * ((1-rho_hat)/(1+rho_hat))^2
    — rather than decaying by a fixed factor: one or two corrections
    land at (or safely below, via ``safety``) the true bound, after
    which the measured and assumed rates agree and the bound freezes.
    Momentum (the recurrence scalars are bound-dependent) restarts from
    the current residual at each correction. Multi-sweep windows are
    essential: single-sweep contraction equioscillates around q^m and a
    per-sweep test false-triggers into a decay spiral (measured).
    ``b`` may be a multi-RHS block; decisions use the Frobenius norm.
    """
    dt = b.dtype
    bn = jnp.sqrt(jnp.vdot(b, b).real).astype(jnp.float32)
    if x0 is None:
        x = jnp.zeros_like(b)
        r = b
    else:
        x = x0
        r = b - matvec(x0)
    hi = jnp.asarray(lmax, jnp.float32)
    lo0 = jnp.asarray(lmin, jnp.float32)
    eps_floor = jnp.float32(np.finfo(np.float32).eps * 64)
    lo_clamp = hi * jnp.float32(1e-12)

    def scalars(lo):
        theta = ((hi + lo) / 2).astype(dt)
        delta = ((hi - lo) / 2).astype(dt)
        return theta, delta, theta / delta

    def step(c):
        x, r, d, rho, lo, rn_mark, s_since, i, done = c
        theta, delta, sigma = scalars(lo)

        def body(_, cc):
            x, r, d, rho_old = cc
            x = x + d
            r = r - matvec(d)
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * r
            return (x, r, d, rho)

        x, r, d, rho = jax.lax.fori_loop(
            0, sweep_iters, body, (x, r, d, rho))
        rn = jnp.sqrt(jnp.vdot(r, r).real).astype(jnp.float32)
        done = rn <= rtol * bn
        s_since = s_since + 1
        # grace just ended (s_since counted up from -grace): start the
        # measurement window here, past the post-restart transient
        rn_mark = jnp.where(s_since == 0, rn, rn_mark)

        # observed per-STEP contraction over the GROWING window since the
        # last correction: short sliding windows are noise-limited (the
        # Chebyshev residual equioscillates, and a noise window implies an
        # arbitrarily small bound — measured decay spiral); a growing
        # window averages the oscillation out
        steps = jnp.maximum(s_since * sweep_iters, 1).astype(jnp.float32)
        rho_hat = jnp.exp(
            jnp.log(jnp.maximum(rn, jnp.float32(1e-30))
                    / jnp.maximum(rn_mark, jnp.float32(1e-30))) / steps)
        kap = hi / jnp.maximum(lo, lo_clamp)
        q = (jnp.sqrt(kap) - 1.0) / (jnp.sqrt(kap) + 1.0)
        at_floor = rn <= eps_floor * bn
        checking = (s_since >= check_every) & ~done & ~at_floor
        q_imp = jnp.clip(rho_hat, jnp.float32(0.0), jnp.float32(0.99999))
        lo_imp = hi * ((1.0 - q_imp) / (1.0 + q_imp)) ** 2 * safety
        # accept only rate-inconsistency that implies a bound >= 4x below
        # the current one (genuine uncovered modes imply orders of
        # magnitude; transient remnants imply ~1x)
        wrong = (checking & (rho_hat > q ** (1.0 / slack))
                 & (lo_imp < lo * 0.25))
        lo_new = jnp.where(wrong, jnp.maximum(lo_imp, lo_clamp), lo)
        # bounds changed -> rebuild the recurrence momentum from r and
        # enter the grace period (the restart transient would otherwise
        # inflate the next window's rate and re-trigger — measured)
        theta_n, _, sigma_n = scalars(lo_new)
        d = jnp.where(wrong, r / theta_n, d)
        rho = jnp.where(wrong, (1.0 / sigma_n).astype(dt), rho)
        s_since = jnp.where(wrong, -jnp.asarray(grace, jnp.int32), s_since)
        return (x, r, d, rho, lo_new, rn_mark, s_since, i + 1, done)

    def cond(c):
        _, _, _, _, _, _, _, i, done = c
        return (~done) & (i < max_sweeps)

    rn0 = jnp.sqrt(jnp.vdot(r, r).real).astype(jnp.float32)
    theta0, _, sigma0 = scalars(lo0)
    x, r, _, _, lo, _, _, i, _ = jax.lax.while_loop(
        cond, step,
        (x, r, r / theta0, (1.0 / sigma0).astype(dt), lo0, rn0,
         jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
         rn0 <= rtol * bn),
    )
    rn = jnp.sqrt(jnp.vdot(r, r).real).astype(jnp.float32)
    return ChebyshevAdaptiveResult(x=x, rnorm=rn, lmin_final=lo, sweeps=i,
                                   sweep_iters=sweep_iters)
