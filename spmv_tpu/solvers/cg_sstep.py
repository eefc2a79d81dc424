"""s-step (communication-avoiding) Conjugate Gradient.

The communication ladder in this library:

- ``cg``: the reference algorithm — 3 dependency-separated global
  reductions per iteration (reference spmv/cg.cpp:49,65,75 — three
  MPI_Allreduce calls gating successive updates).
- ``cg_pipelined``: Chronopoulos-Gear recurrence — the two scalars fuse
  into ONE collective per iteration.
- ``cg_sstep`` (this module): s-step CG (Chronopoulos & Gear '89; the
  basis-conditioning treatment follows the communication-avoiding Krylov
  line of Hoemmen '10 / Carson '15) — ONE collective per **s iterations**.

Why it matters on a large mesh: the SpMV halo exchange is neighbor-local
(ppermute, latency hidden behind the interior SpMV), but a CG
dot product is a full-mesh ``psum`` whose latency grows with mesh
diameter and cannot overlap with anything — it gates alpha/beta. At pod
scale the solve becomes REDUCTION-latency-bound; s-step CG amortizes one
reduction over s iterations, the strongest communication reduction short
of changing the method.

Algorithm (per outer step = s CG iterations):

1. Build the Krylov basis V = [rho_0(A) r, ..., rho_s(A) r] (s matvecs,
   halo exchanges only — no reductions). rho_j are CHEBYSHEV polynomials
   shifted to [lo, hi] ⊇ spec(A): |rho_j| <= 1 on the spectrum, so the
   basis stays numerically independent where the monomial basis
   [r, Ar, A²r, ...] loses a factor ~||A||^j per column (the classic
   s-step instability). The three-term recurrence gives A V[:, :s] =
   V @ B for a known (s+1, s) tridiagonal B — so every A-product below
   is EXACT small-matrix algebra, no extra matvecs.
2. ONE fused Gram reduction: Z = [Q_prev; V]^T V ((2s+1, s+1) — a single
   matmul whose cross-shard sum is one psum). Everything else this outer
   step is (s x s)-scale math: replicated on every device, microseconds.
3. A-conjugate the new block against the previous direction block
   (C = D_prev^+ (Q^T A P)); the s-step CG theorem is that single-block
   conjugation preserves global A-conjugacy in exact arithmetic — the
   block analogue of CG's three-term recurrence.
4. Galerkin solve in the block: D a = P'^T r with D = P'^T A P' (s x s,
   eigendecomposition-based pseudo-inverse so directions that have
   CONVERGED inside the block drop out instead of dividing by ~0), then
   x += P' a, r -= (A P') a.

In exact arithmetic the outer-step iterates EQUAL plain CG's every s
iterations (both minimize the A-norm error over x0 + K_{ks}(A, r0)); in
floating point the parity test pins the difference. Convergence
monitoring costs ZERO extra reductions: |r|^2 at each block's entry is
the free Gram by-product G[0, 0] — a true dot of an actual residual
vector, used one block stale (at most s matvecs of overshoot, which
still improve x; small-matrix |r|^2 identities were tried and rejected —
they cancel catastrophically at fp32 and can exit the loop early on a
corrupted estimate). The final report recomputes the TRUE residual once
outside the loop.

Envelope: SPD operators, modest s (4-8). The Chebyshev basis needs an
upper spectral bound; pass ``lambda_bounds=(0, lmax)`` (e.g. from
``lanczos_extreme``) or let the one-time internal power iteration
estimate it. In fp32 the block updates accumulate rounding faster than
plain CG's scalar recurrences: the attainable relative residual floors
around ~kappa * eps (measured 3e-4 at kappa ~ 1.7e3 vs plain CG's 9e-6),
and beyond kappa ~ 1e4 the fp32 iteration stalls or diverges outright
(it is the precision, not the device; every matmul here runs at
precision=HIGHEST because reduced-precision products — TF32 on GPUs —
corrupt the block recurrences).
The solver is divergence-SAFE, not divergence-free: non-finite or
1e4x-grown residuals exit the loop, the best iterate visited is
returned, and ``converged``/``rnorm`` report the true final residual —
use the f64 mesh or ``cg``/``cg_refined`` for fp32 high-kappa work. The
reference has nothing on this axis — its CG is the 3-reduction classic.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from spmv_tpu.solvers.cg import CGResult
from spmv_tpu.utils.precision import highest_precision


def _mm(a, b):
    """Matmul at HIGHEST precision: a reduced-precision f32 product (TF32
    on GPUs, ~1e-3 relative error) drives the block recurrences to NaN at
    kappa ~ 2.6e4. Every matrix product here is tiny next to the SpMVs."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _pinv_solve(M, y):
    """Solve symmetric-PSD ``M x = y`` via eigh pseudo-inverse: eigenvalues
    below a relative floor are DROPPED (their directions carry no
    information — e.g. search directions already converged inside the
    block), not inverted into noise."""
    w, U = jnp.linalg.eigh(M)
    wmax = jnp.maximum(jnp.max(jnp.abs(w)), jnp.finfo(w.dtype).tiny)
    tol = wmax * jnp.asarray(jnp.finfo(w.dtype).eps, w.dtype) * M.shape[0] * 8
    safe = jnp.where(w > tol, w, jnp.ones_like(w))
    winv = jnp.where(w > tol, 1.0 / safe, jnp.zeros_like(w))
    z = _mm(U.T.conj(), y)
    scale = winv if z.ndim == 1 else winv[:, None]
    return _mm(U, scale * z)


def _estimate_lmax(matvec_flat, v0, iters: int = 12):
    """One-time power-iteration estimate of lambda_max (SPD A). Slight
    under-estimates are harmless for the Chebyshev basis (|rho_j| grows
    only slowly just outside [lo, hi]); 10% headroom is added by the
    caller."""
    tiny = jnp.asarray(jnp.finfo(v0.dtype).tiny, jnp.real(v0).dtype)
    n0 = jnp.sqrt(jnp.real(jnp.vdot(v0, v0)))
    v0 = v0 / jnp.maximum(n0, tiny).astype(v0.dtype)

    def step(carry, _):
        v, _ = carry
        w = matvec_flat(v)
        nw = jnp.sqrt(jnp.real(jnp.vdot(w, w)))
        return (w / jnp.maximum(nw, tiny).astype(w.dtype), nw), None

    (_, lam), _ = jax.lax.scan(
        step, (v0, jnp.zeros((), jnp.real(v0).dtype)), None, length=iters)
    return lam


@highest_precision
def cg_sstep(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    s: int = 4,
    kmax: int = 100,
    rtol: float = 1e-10,
    lambda_bounds: tuple | None = None,
    basis_builder: Callable | None = None,
    replace_every: int = 0,
) -> CGResult:
    """Solve SPD ``A x = b`` with s-step CG: one global reduction per
    ``s`` iterations (module docstring). Semantics follow ``cg``:
    vectors in b's (padded) layout with zero padding, ``kmax`` counts CG
    iterations (rounded up to whole s-blocks), convergence on
    |r|/|r0| < rtol. The returned ``rnorm`` is the TRUE final residual
    norm (recomputed once outside the loop); ``iterations`` counts
    matvecs consumed by completed blocks.

    ``lambda_bounds=(lo, hi)``: spectral enclosure for the Chebyshev
    basis — ``(0, lmax)`` is always valid for SPD A and costs nothing in
    conditioning; if omitted, a 12-step power iteration estimates lmax
    once (s extra matvecs' worth of setup, amortized over the solve).

    Preconditioning composes by SPLITTING, not by an M^-1 argument (a
    left-preconditioned s-step basis would need every Gram in the
    M-inner product): for a factorized SPD preconditioner M^-1 = G^T G
    (``fsai_setup``; Jacobi is G = diag(A)^-1/2) solve the equivalent
    SPD system (G A G^T) y = G b with ``matvec=lambda v:
    G(A(Gt(v)))`` and recover x = G^T y — three SpMVs per apply, zero
    extra reductions, and the s-step communication structure untouched.
    ``tests/test_cg_sstep.py::test_sstep_fsai_split_preconditioned``
    demonstrates the pattern end to end.

    ``basis_builder``: optional replacement for the internal s-matvec
    basis build — ``basis_builder(r, c, e) -> (s+1, *r.shape)`` must
    return the same shifted-Chebyshev basis [rho_0(A) r, ..., rho_s(A) r]
    for the bounds-derived (c, e). The matrix-powers kernel
    (``spmv_tpu.parallel.powers.chebyshev_powers_basis``) plugs in here
    to build the whole basis with ONE halo exchange instead of s — the
    fully communication-avoiding configuration.

    ``replace_every=k``: residual replacement — every k-th block,
    recompute ``r = b - A x`` instead of carrying the recurrence
    residual, at 1/k extra matvecs per block. At fp32 this both lifts
    the attainable floor ~6-8x (measured 3.0e-4 -> 5.1e-5 at kappa ~
    1.7e3 with k in {1,2,4}) and stops the drifted recurrence from
    triggering a false early exit; it does NOT restore plain CG's fp32
    floor (the remaining gap is fp32 Galerkin/conjugation rounding) —
    use f64 when that matters. 0 (default) disables it.
    """
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if x0 is None:
        x0 = jnp.zeros_like(b)
    vshape = b.shape
    n = b.size
    rdtype = jnp.finfo(b.dtype).dtype
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, rdtype)

    def mv(v):
        return matvec(v.reshape(vshape)).reshape(n)

    r0 = (b - matvec(x0)).reshape(n)
    xf0 = x0.reshape(n)
    rnorm2_0 = jnp.real(jnp.vdot(r0, r0))
    rnorm0 = jnp.sqrt(rnorm2_0)

    if lambda_bounds is None:
        lo = jnp.zeros((), rdtype)
        hi = _estimate_lmax(mv, r0) * jnp.asarray(1.1, rdtype)
    else:
        lo = jnp.asarray(lambda_bounds[0], rdtype)
        hi = jnp.asarray(lambda_bounds[1], rdtype)
    c = (hi + lo) / 2
    e = jnp.maximum((hi - lo) / 2, tiny)

    # three-term recurrence matrix: A V[:, :s] = V @ B exactly
    #   A v_0 = c v_0 + e v_1;  A v_j = c v_j + e/2 (v_{j+1} + v_{j-1})
    B = jnp.zeros((s + 1, s), b.dtype)
    B = B.at[jnp.arange(s), jnp.arange(s)].set(c.astype(b.dtype))
    sub = jnp.where(jnp.arange(s) == 0, e, e / 2).astype(b.dtype)
    B = B.at[jnp.arange(1, s + 1), jnp.arange(s)].set(sub)
    if s > 1:
        B = B.at[jnp.arange(s - 1), jnp.arange(1, s)].set(
            (e / 2).astype(b.dtype))

    def build_basis(r):
        if basis_builder is not None:
            # e.g. the matrix-powers kernel: whole basis, ONE exchange
            return basis_builder(r.reshape(vshape), c, e).reshape(s + 1, n)
        # shifted-Chebyshev Krylov basis of r: s matvecs, zero reductions
        vs = [r, (mv(r) - c.astype(b.dtype) * r) / e.astype(b.dtype)]
        for _ in range(1, s):
            vs.append(2 * (mv(vs[-1]) - c.astype(b.dtype) * vs[-1])
                      / e.astype(b.dtype) - vs[-2])
        return jnp.stack(vs)  # (s+1, n) rows

    n_outer = -(-kmax // s)

    def cond(state):
        # rnorm2 is |r|^2 at the ENTRY of the block just run (the free
        # G[0,0] by-product): a TRUE dot of an actual residual vector, one
        # block stale. The loop therefore overshoots convergence by at most
        # one block (s matvecs, which still improve x) but can never exit
        # on a cancellation-corrupted estimate — the failure mode of
        # updating |r|^2 through small-matrix identities at fp32. Two
        # additional exits make low-precision high-kappa failure graceful
        # instead of NaN: a non-finite residual and a divergence cap
        # (|r| grown 1e4x over |r0| — no healthy CG trajectory does that).
        k, _x, _r, _Q, _S, _D, rnorm2, _xb, _rb = state
        rn = jnp.sqrt(jnp.maximum(rnorm2, 0.0))
        # divergence cap keyed to dtype: CG's 2-norm residual can grow
        # transiently up to ~sqrt(kappa) over |r0| on HEALTHY trajectories,
        # and f64 handles kappa far beyond fp32 — cap at ~1/sqrt(eps)
        # (1e4 for f32, ~6.7e7 for f64) so only precision-impossible
        # growth exits early
        cap = jnp.maximum(
            jnp.asarray(1e4, rdtype),
            1.0 / jnp.sqrt(jnp.asarray(jnp.finfo(b.dtype).eps, rdtype)))
        return ((k < n_outer)
                & (rn / jnp.maximum(rnorm0, tiny) >= rtol)
                & jnp.isfinite(rn)
                & (rn <= cap * rnorm0 + tiny))

    def body(state):
        k, x, r, Q, S, D, _rn2, x_best, rn2_best = state
        V = build_basis(r)                       # s matvecs (halo only)
        W = jnp.concatenate([Q, V], axis=0)      # (2s+1, n)
        Z = _mm(W.conj(), V.T)                   # ONE fused psum reduction
        QtV, G = Z[:s], Z[s:]
        # G[0,0] = |r|^2 of the CURRENT x: snapshot the best iterate seen
        # so a later fp32 divergence cannot destroy delivered progress
        g00 = jnp.real(G[0, 0])
        better = jnp.isfinite(g00) & (g00 < rn2_best)
        x_best = jnp.where(better, x, x_best)
        rn2_best = jnp.where(better, g00, rn2_best)
        E = _mm(QtV, B)                          # Q^T A P   (s, s)
        C = _pinv_solve(D, E)                    # block A-conjugation coef
        PAP = _mm(G[:s], B)                      # P^T A P   (s, s)
        Dn = PAP - _mm(E.T.conj(), C)
        Dn = 0.5 * (Dn + Dn.T.conj())
        g = G[:s, 0] - _mm(C.T.conj(), QtV[:, 0])  # P'^T r
        a = _pinv_solve(Dn, g)
        Pp = V[:s] - _mm(C.T.conj(), Q)          # conjugated directions
        Sp = _mm(B.T, V) - _mm(C.T.conj(), S)    # A P' (exact, no matvec)
        x = x + _mm(a, Pp)
        r = r - _mm(a, Sp)
        if replace_every:
            # residual replacement (van der Vorst/Carson): re-anchor the
            # recurrence residual to b - A x so later blocks project
            # against the TRUE residual instead of a drifted one — the
            # low-precision drift killer, at 1/replace_every extra
            # matvecs per block
            r = jax.lax.cond(
                (k + 1) % replace_every == 0,
                lambda: (b - matvec(x.reshape(vshape))).reshape(n),
                lambda: r)
        return (k + 1, x, r, Pp, Sp, Dn, g00, x_best, rn2_best)

    Q0 = jnp.zeros((s, n), b.dtype)
    D0 = jnp.eye(s, dtype=b.dtype)
    k, x, _r, _Q, _S, _D, _rn2, x_best, rn2_best = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), xf0, r0, Q0, Q0, D0, rnorm2_0, xf0, rnorm2_0))

    # true-residual recomputation outside the loop; if the final iterate is
    # non-finite or GROSSLY worse than the best block-entry snapshot (fp32
    # stall/divergence), the snapshot is returned — the solver never hands
    # back garbage silently. The 4x gate matters: healthy CG is monotone in
    # the A-norm of the error but NOT in |r|_2 (early iterations routinely
    # grow it ~1.5x), and second-guessing that transient would break the
    # exact block-equivalence to plain CG.
    r_x = (b - matvec(x.reshape(vshape))).reshape(n)
    rn_x = jnp.sqrt(jnp.real(jnp.vdot(r_x, r_x)))
    use_best = (~jnp.isfinite(rn_x)) | (
        rn_x > 4.0 * jnp.sqrt(jnp.maximum(rn2_best, 0.0)))
    x = jnp.where(use_best, x_best, x)
    # lax.cond, not jnp.where: the snapshot's matvec must only run on the
    # (rare) fallback path — where would evaluate both branches and pay an
    # unconditional second matvec+halo per solve
    r_true = jax.lax.cond(
        use_best,
        lambda: (b - matvec(x_best.reshape(vshape))).reshape(n),
        lambda: r_x)
    rnorm = jnp.sqrt(jnp.real(jnp.vdot(r_true, r_true)))
    return CGResult(
        x=x.reshape(vshape),
        iterations=k * s,
        rnorm=rnorm.astype(rdtype),
        rnorm0=rnorm0.astype(rdtype),
        converged=rnorm / jnp.maximum(rnorm0, tiny) < rtol,
        r=r_true.reshape(vshape),
        p=None,
    )
