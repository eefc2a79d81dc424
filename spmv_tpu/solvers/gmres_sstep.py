"""s-step (communication-avoiding) GMRES for general nonsymmetric systems.

``cg_sstep`` closes the communication ladder for SPD operators; this
module is the nonsymmetric rung — CA-GMRES in the Demmel/Hoemmen/
Mohiyuddin line (Hoemmen '10 "communication-avoiding Krylov" thesis,
CA-Arnoldi). The reference library has no GMRES at all (its only solver
is the 3-reduction CG, reference spmv/cg.cpp:21-98); standard restarted
``gmres`` here already cuts orthogonalization to batched CGS2 matmuls,
but still pays per ITERATION: 3 global reductions (two projection
passes + the norm) and one halo exchange. At pod scale both are
latency walls. CA-GMRES amortizes both over s iterations:

Per block of s Arnoldi steps (m = t*s steps already done, q_m the last
orthonormal vector):

1. Build the shifted-Chebyshev Krylov basis V = [rho_0(A) q_m, ...,
   rho_s(A) q_m] — s matvecs with NO reductions, or ONE deep halo
   exchange when the matrix-powers kernel supplies ``basis_builder``
   (`spmv_tpu.parallel.powers.chebyshev_powers_basis`). The three-term
   recurrence gives A V[:s] = B^T V exactly for a known (s+1, s)
   tridiagonal B — the block's A-action is small-matrix algebra.
2. Block-orthogonalize V[1:] against ALL previous Q rows with BCGS2
   (two classical Gram-Schmidt passes, each ONE (M+1, n)-matmul
   reduction — unwritten Q rows are zero, so no masking is needed),
   then orthonormalize within the block by CholQR2 (two Gram+Cholesky
   passes, one reduction each). Total: 4 fused reductions per s
   iterations vs 3s for standard GMRES — and every one is a big matmul
   psum instead of a latency-bound scalar dot.
3. Recover the s new Hessenberg columns EXACTLY from the basis-change
   algebra, no extra communication: with Rbar the coefficients of V in
   the orthonormal basis (Rbar[:, 0] = e_m; columns j >= 1 stack the
   BCGS coefficients over the CholQR2 triangle), A V[:s] = B^T V and
   A Q = Q H combine into  H @ Rbar[:, :s] = Rbar @ B, whose only
   unknowns are H's columns m..m+s-1. The trailing coefficient block
   T = Rbar[m:m+s, :s] is upper triangular with positive diagonal
   (T[0,0] = 1, T[k,k] = CholQR diag), so
       H_new = (Rbar @ B - H @ Rbar[:M, :s]) @ T^{-1}
   is one (M+1, s) triangular solve of replicated small matrices.
4. One replicated least-squares solve of min |beta e_0 - H y| gives the
   running residual estimate; the block loop EXITS EARLY on
   convergence, mirroring ``gmres``'s per-step Givens exit at block
   granularity (overshoot <= s-1 steps).

Basis conditioning: the Chebyshev polynomials are shifted to
``lambda_bounds`` = [lo, hi]. For a basis (unlike for the Chebyshev
SOLVER) the interval does not need to enclose the spectrum for
correctness — any basis of the Krylov space yields the same Arnoldi
space in exact arithmetic — it only controls CONDITIONING: |rho_j| <= 1
on [lo, hi] keeps the basis columns comparable in size where the
monomial basis loses ~||A||^j per column. For nonsymmetric operators
with spectra near the real axis (convection-diffusion and friends) the
real enclosure works as-is; strongly complex spectra degrade the basis
conditioning at large s — use modest s (2-4) or fall back to ``gmres``.
If bounds are omitted, a 12-step power iteration estimates the dominant
|lambda| once.

Precision: every Gram/projection/recovery matmul runs at
precision=HIGHEST — a reduced-precision f32 product (TF32 on GPUs)
corrupts the Hessenberg recovery exactly as it corrupts cg_sstep's block
recurrences.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.solvers.cg_sstep import _estimate_lmax, _mm
from spmv_tpu.solvers.gmres import GMRESResult
from spmv_tpu.utils.precision import highest_precision


@highest_precision
def gmres_sstep(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    s: int = 4,
    restart: int = 32,
    max_cycles: int = 20,
    rtol: float = 1e-10,
    lambda_bounds: tuple | None = None,
    basis_builder: Callable | None = None,
    shifts=None,
    newton_ops=None,
) -> GMRESResult:
    """Solve general ``A x = b`` with s-step GMRES(restart): 4 fused
    global reductions per ``s`` Arnoldi steps (module docstring) instead
    of 3 per step. Semantics follow ``gmres``: vectors keep b's (padded)
    layout with zero padding, restart cycles until |r|/|r0| < ``rtol``
    or ``max_cycles``; the returned ``rnorm`` is the TRUE residual of
    the final iterate and ``iterations`` counts Arnoldi steps from
    completed blocks (block granularity — convergence overshoot is at
    most s-1 steps). ``restart`` is rounded up to whole s-blocks.

    ``lambda_bounds=(lo, hi)``: real interval for the shifted-Chebyshev
    basis polynomials — conditioning only, NOT a spectral-enclosure
    requirement (module docstring); defaults to ``(0, 1.1 * |lambda|)``
    from a one-time power iteration.

    ``basis_builder(q, c, e) -> (s+1, *q.shape)``: optional replacement
    for the internal s-matvec basis build; the matrix-powers kernel
    (``chebyshev_powers_basis`` over a depth-s ``PowersPlan``) plugs in
    here to build each block's basis from ONE halo exchange — the fully
    communication-avoiding nonsymmetric configuration.

    Preconditioning composes by OPERATOR COMPOSITION, not an argument
    (the same stance as ``cg_sstep``'s split preconditioning): for a
    fixed linear M ~ A^-1 solve the right-preconditioned system
    ``A M u = b`` with ``matvec=lambda v: A(M(v))`` and recover
    ``x = M u`` — zero extra reductions, the CA structure untouched
    (``tests/test_gmres_sstep.py`` demonstrates with SPAI). A per-apply
    VARIABLE preconditioner needs stored Z-directions (FGMRES) and
    cannot ride an s-step basis — use ``gmres(flexible=True)``.

    ``shifts``: STATIC complex shift candidates (numpy array-like, e.g.
    Ritz values from ``arnoldi_ritz`` / ``newton_shifts_from_operator``)
    switching the block basis from shifted-Chebyshev to the Leja-ordered
    real NEWTON basis (``solvers/newton_basis``) — the conditioning fix
    for spectra with large imaginary extent, where the Chebyshev basis
    on a real interval blows up geometrically in s. When given,
    ``lambda_bounds`` is ignored and ``basis_builder`` is called with
    the single argument ``q``.

    ``newton_ops``: a PRECOMPUTED ops tuple from ``newton_basis_ops``
    (alternative to ``shifts``; takes precedence). This is the safe MPK
    hookup: compute ``ops = newton_basis_ops(ritz, s)`` ONCE and pass
    the SAME object both here and to the builder's
    ``newton_powers_basis(pp, q, ops)`` closure — the Hessenberg
    recovery matrix B is derived from exactly the ops the builder runs.
    (With ``shifts`` + ``basis_builder`` instead, the internal
    ``newton_basis_ops(shifts, s)`` must match what the builder closed
    over — same s, same un-truncated shifts — or the recovered
    Hessenberg is silently wrong and surfaces only as non-convergence
    via the true-residual guard.)

    Envelope: real (non-complex) operators; spectra far off the real
    axis degrade the default Chebyshev basis conditioning (use
    ``shifts`` — or small s, or ``gmres``). CholQR2
    needs the block-basis condition SQUARED representable: kappa(basis)
    up to ~1/sqrt(eps) per block (~3e3 at fp32, ~1e8 at f64) — keep
    ``lambda_bounds`` roughly enclosing the spectrum at fp32 (the f64
    tests survive a deliberately 1e7-conditioned basis). Like ``gmres``,
    a saved solution passed as ``x0`` is an exact warm resume."""
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if jnp.iscomplexobj(b):
        raise ValueError("gmres_sstep supports real dtypes; use gmres "
                         "for complex systems")
    if x0 is None:
        x0 = jnp.zeros_like(b)
    T_blocks = -(-restart // s)
    M = T_blocks * s
    vshape = b.shape
    n = b.size
    rdtype = jnp.finfo(b.dtype).dtype
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, rdtype)

    def mv(v):
        return matvec(v.reshape(vshape)).reshape(n)

    r_init = (b - matvec(x0)).reshape(n)
    rnorm0 = jnp.sqrt(jnp.maximum(r_init @ r_init, 0.0))

    if shifts is not None or newton_ops is not None:
        # Leja-ordered real Newton basis (solvers/newton_basis): static
        # per-step ops (alpha, gamma, sigma); the recurrence matrix B is
        # exact by construction. np.asarray rejects traced shift arrays
        # with a clear ConcretizationTypeError — shifts are host data.
        from spmv_tpu.solvers.newton_basis import (
            newton_basis_ops,
            newton_recurrence_matrix,
        )

        if newton_ops is not None:
            ops = tuple(newton_ops)
            if len(ops) != s:
                raise ValueError(
                    f"newton_ops length {len(ops)} != s={s}")
        else:
            ops = newton_basis_ops(np.asarray(shifts), s)
        B = jnp.asarray(newton_recurrence_matrix(ops, np.dtype(b.dtype)))

        def build_basis(q):
            if basis_builder is not None:
                return basis_builder(q.reshape(vshape)).reshape(s + 1, n)
            vs = [q]
            for alpha, gamma, sigma in ops:
                w = mv(vs[-1]) - jnp.asarray(alpha, b.dtype) * vs[-1]
                if gamma != 0.0:
                    w = w + jnp.asarray(gamma, b.dtype) * vs[-2]
                vs.append(w / jnp.asarray(sigma, b.dtype))
            return jnp.stack(vs)  # (s+1, n) rows
    else:
        if lambda_bounds is None:
            lo = jnp.zeros((), rdtype)
            hi = _estimate_lmax(mv, r_init) * jnp.asarray(1.1, rdtype)
        else:
            lo = jnp.asarray(lambda_bounds[0], rdtype)
            hi = jnp.asarray(lambda_bounds[1], rdtype)
        c = ((hi + lo) / 2).astype(b.dtype)
        e = jnp.maximum((hi - lo) / 2, tiny).astype(b.dtype)

        # three-term recurrence matrix: A V[:s] (rows) = B^T V, i.e. for
        # columns A V[:, :s] = V @ B with B (s+1, s):
        #   A v_0 = c v_0 + e v_1;  A v_j = c v_j + e/2 (v_{j+1} + v_{j-1})
        B = jnp.zeros((s + 1, s), b.dtype)
        B = B.at[jnp.arange(s), jnp.arange(s)].set(c)
        sub = jnp.where(jnp.arange(s) == 0, e, e / 2).astype(b.dtype)
        B = B.at[jnp.arange(1, s + 1), jnp.arange(s)].set(sub)
        if s > 1:
            B = B.at[jnp.arange(s - 1), jnp.arange(1, s)].set(e / 2)

        def build_basis(q):
            if basis_builder is not None:
                return basis_builder(q.reshape(vshape), c, e).reshape(
                    s + 1, n)
            vs = [q, (mv(q) - c * q) / e]
            for _ in range(1, s):
                vs.append(2 * (mv(vs[-1]) - c * vs[-1]) / e - vs[-2])
            return jnp.stack(vs)  # (s+1, n) rows

    def chol_qr(W):
        """One CholQR pass: W = L @ Q with L lower triangular. The Gram
        is the block's ONE fused reduction; a relative jitter keeps the
        factorization finite at lucky breakdown (the dependent columns
        then carry junk directions whose Hessenberg weight is ~0 and the
        residual estimate has already converged — the block exit path)."""
        G = _mm(W, W.T)                      # (s, s) — one psum
        jit_ = jnp.trace(G) * jnp.asarray(
            jnp.finfo(rdtype).eps, rdtype) * (4 * s)
        L = jnp.linalg.cholesky(G + jit_ * jnp.eye(s, dtype=G.dtype))
        Qn = jax.scipy.linalg.solve_triangular(L, W, lower=True)
        return Qn, L

    def block_body(carry):
        t, Q, H, live, est = carry
        m = t * s
        q_start = jax.lax.dynamic_index_in_dim(Q, m, axis=0, keepdims=False)
        V = build_basis(q_start)             # (s+1, n), V[0] = q_m

        # BCGS2 against ALL previous rows (unwritten rows are zero —
        # projections against them vanish, no mask needed)
        W = V[1:]                            # (s, n)
        C2 = jnp.zeros((M + 1, s), b.dtype)
        for _ in range(2):
            Cp = _mm(Q, W.T)                 # (M+1, s) — one psum
            W = W - _mm(Cp.T, Q)
            C2 = C2 + Cp
        # CholQR2 within the block: W = L1 @ Qn1, Qn1 = L2 @ Qn2, so
        # W = (L1 @ L2) @ Qn2 — the factor product composes in FIRST-pass-
        # first order and stays lower triangular
        Qn, L1 = chol_qr(W)
        Qn, L2 = chol_qr(Qn)
        L_total = _mm(L1, L2)

        # coefficients of V in the orthonormal basis:
        #   Rbar[:, 0] = e_m;  Rbar[i, j>=1] = C2[i, j-1] (i <= m)
        #   Rbar[m+1+k, j>=1] = L_total[j-1, k]
        Rbar = jnp.zeros((M + 1, s + 1), b.dtype)
        Rbar = Rbar.at[:, 0].set(
            (jnp.arange(M + 1) == m).astype(b.dtype))
        Rbar = Rbar.at[:, 1:].set(C2)
        Rbar = jax.lax.dynamic_update_slice(Rbar, L_total.T, (m + 1, jnp.int32(1)))

        # Hessenberg recovery: H @ Rbar[:, :s] = Rbar @ B, unknowns =
        # columns m..m+s-1; T = Rbar[m:m+s, :s] upper triangular
        T_mat = jax.lax.dynamic_slice(Rbar, (m, jnp.int32(0)), (s, s))
        RHS = _mm(Rbar, B) - _mm(H, Rbar[:M, :s])       # (M+1, s)
        H_new = jax.scipy.linalg.solve_triangular(
            T_mat.T, RHS.T, lower=True).T
        # exact-arithmetic support is rows <= m+s; mask the rounding tail
        H_new = H_new * (jnp.arange(M + 1)[:, None] <= m + s).astype(b.dtype)
        H = jax.lax.dynamic_update_slice(H, H_new, (jnp.int32(0), m))
        Q = jax.lax.dynamic_update_slice(Q, Qn, (m + 1, jnp.int32(0)))

        # replicated small-LS residual estimate (columns beyond m+s are
        # zero -> pinv drops them); block-granular early exit
        g = jnp.zeros((M + 1,), b.dtype).at[0].set(beta_cur[0])
        y, _, _, _ = jnp.linalg.lstsq(H, g)
        est = jnp.sqrt(jnp.maximum((g - _mm(H, y[:, None])[:, 0])
                                   @ (g - _mm(H, y[:, None])[:, 0]), 0.0))
        live = (est >= rtol * jnp.maximum(rnorm0, tiny)) & jnp.isfinite(est)
        return (t + 1, Q, H, live, est)

    def block_cond(carry):
        t, _Q, _H, live, _est = carry
        return (t < T_blocks) & live

    def cycle_body(state):
        x, r, k_total, cycles, rnorm_prev, _failed = state
        beta = jnp.sqrt(jnp.maximum(r @ r, 0.0))
        beta_cur[0] = beta  # captured by block_body (trace-time cell)
        v0 = r / jnp.maximum(beta, tiny)
        Q0 = jnp.zeros((M + 1, n), b.dtype).at[0].set(v0)
        H0 = jnp.zeros((M + 1, M), b.dtype)
        t, Q, H, _live, _est = jax.lax.while_loop(
            block_cond, block_body,
            (jnp.int32(0), Q0, H0, jnp.asarray(True),
             jnp.asarray(jnp.inf, rdtype)))
        g = jnp.zeros((M + 1,), b.dtype).at[0].set(beta)
        y, _, _, _ = jnp.linalg.lstsq(H, g)
        x2 = x + _mm(y[None, :], Q[:M])[0].reshape(vshape)
        r2 = (b - matvec(x2)).reshape(n)
        rnorm2 = jnp.sqrt(jnp.maximum(r2 @ r2, 0.0))
        # a breakdown-corrupted cycle (NaN basis or residual GROWTH past
        # any healthy restart transient) must not destroy the iterate:
        # keep the previous x/r, flag failure, exit — never return junk
        ok = jnp.isfinite(rnorm2) & (rnorm2 <= 4.0 * rnorm_prev + tiny)
        x = jnp.where(ok, x2, x)
        r_new = jnp.where(ok, r2, r)
        rnorm = jnp.where(ok, rnorm2, rnorm_prev)
        return (x, r_new, k_total + t * s, cycles + jnp.int32(1), rnorm,
                jnp.logical_not(ok))

    def cycle_cond(state):
        _x, _r, _k, cycles, rnorm, failed = state
        return ((cycles < max_cycles)
                & (rnorm / jnp.maximum(rnorm0, tiny) >= rtol)
                & jnp.logical_not(failed))

    beta_cur = [rnorm0]  # trace-time cell: set per cycle, read per block
    x, _r, k_total, cycles, rnorm, _failed = jax.lax.while_loop(
        cycle_cond, cycle_body,
        (x0, r_init, jnp.int32(0), jnp.int32(0), rnorm0,
         jnp.asarray(False)))
    return GMRESResult(
        x=x,
        iterations=k_total,
        cycles=cycles,
        rnorm=rnorm.astype(rdtype),
        rnorm0=rnorm0.astype(rdtype),
        converged=rnorm / jnp.maximum(rnorm0, tiny) < rtol,
    )
