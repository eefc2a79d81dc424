"""Mixed-precision iterative refinement: float64-class solves from fp32 CG.

The reference solves in double everywhere (reference spmv/cg.cpp, double
only). The mixed-precision alternative (Wilkinson iterative refinement)
keeps the hot loop in float32:

    repeat:
        r = b - A x          # in double-single (exact to ~2^-48)
        d ~= A^{-1} r        # inner CG in fp32, loose tol
        x = x + d            # accumulated in double-single

Each outer pass multiplies the error by ~inner_tol, so 3-4 passes reach
~1e-14 TRUE residual — accuracy plain fp32 CG can never achieve (its floor
is kappa * eps_f32), at fp32 SpMV speed. The attainable floor is
~ kappa * 2^-48 relative (double-single residual precision); the loop stops
early when it stalls there. The outer loop runs on host (a handful of jit
calls); all hot work is the fp32 CG and the DS SpMV.

``cg_refined`` takes single-device operators (DiaMatrix fp32 +
DiaDsMatrix); ``cg_refined_dist`` runs on a device mesh (DS halos).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.ds import ds_add, ds_from_f64, ds_to_f64
from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.formats.dia import csr_to_dia
from spmv_tpu.ops.spmv_dia import spmv_dia_2d
from spmv_tpu.ops.spmv_dia_ds import csr_to_dia_ds, spmv_dia_ds_2d
from spmv_tpu.solvers.cg import cg

LANES = 128


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray            # f64 solution (length nrows)
    outer_iterations: int
    inner_iterations: int
    rnorm: float             # final TRUE residual norm (double-single)
    converged: bool
    history: list            # per-outer-pass |r|


def cg_refined(
    a: CSRHost,
    b: np.ndarray,
    rtol: float = 1e-12,
    max_outer: int = 6,
    inner_rtol: float = 1e-6,
    inner_kmax: int = 500,
    jacobi: bool = False,
) -> RefineResult:
    """Solve SPD ``a x = b`` to float64-class TRUE residual using fp32
    compute. ``a`` must be banded (DIA-convertible); fp64 values honored via
    double-single storage. ``jacobi=True`` diagonal-scales the fp32 inner
    solves — for ill-conditioned systems this cuts inner iterations without
    touching the refinement floor (the DS residual path is unchanged).
    """
    d32 = csr_to_dia(a, dtype=np.float32)
    dds = csr_to_dia_ds(a)
    npad = dds.nrows_pad
    n = a.nrows

    bh, bl = ds_from_f64(np.pad(np.asarray(b, np.float64), (0, npad - n)))
    bh2 = jnp.asarray(bh.reshape(-1, LANES))
    bl2 = jnp.asarray(bl.reshape(-1, LANES))
    bnorm = float(np.linalg.norm(b))

    @jax.jit
    def residual_ds(dds_, bh2_, bl2_, xh2, xl2):
        """r = b - A x in double-single (both SpMV legs + subtraction).
        b passed as an argument (capture would embed it as a program
        constant). Only the HIGH plane is returned: it is the correctly
        rounded f32 image of the exactly-accumulated residual — all the
        fp32 inner solve can consume; the sub-f32 tail rl would only be
        held alive for nothing (0.4 GB at 100M rows)."""
        yh, yl = spmv_dia_ds_2d(dds_, xh2, xl2)
        rh, _rl = ds_add(bh2_, bl2_, -yh, -yl)
        return rh

    diag2 = None
    if jacobi:
        lens = a.row_nnz()
        rows = np.repeat(np.arange(n), lens)
        on_diag = a.colind == rows
        diag = np.zeros(npad, np.float32)
        diag[rows[on_diag]] = a.values[on_diag]
        diag2 = jnp.asarray(diag.reshape(-1, LANES))

    @jax.jit
    def inner_solve(d32_, rh2, scale, diag2_):
        """fp32 CG on the scaled residual. The diagonal arrives as an
        ARGUMENT — a closure capture would embed it as a literal constant
        in the compiled program (the 2-GB-through-the-compiler bug class,
        see dist_matrix pytree note)."""
        rs = rh2 * scale
        precond = None
        if jacobi:
            def precond(r2):
                return jnp.where(diag2_ != 0,
                                 r2 / jnp.where(diag2_ != 0, diag2_, 1), r2)

        res = cg(lambda p2: spmv_dia_2d(d32_, p2), rs, kmax=inner_kmax, rtol=inner_rtol,
                 preconditioner=precond)
        return res.x, res.iterations

    xh2 = jnp.zeros((npad // LANES, LANES), jnp.float32)
    xl2 = jnp.zeros_like(xh2)
    history = []
    inner_total = 0
    converged = False
    stalls = 0
    for _ in range(max_outer):
        rh2 = residual_ds(dds, bh2, bl2, xh2, xl2)
        rnorm = float(jnp.linalg.norm(rh2.reshape(-1)[: n]))
        history.append(rnorm)
        if rnorm <= rtol * bnorm:
            converged = True
            break
        if len(history) > 1 and rnorm > 0.95 * history[-2]:
            stalls += 1
            if stalls >= 2:
                # stalled at the attainable floor (~ kappa * 2^-48
                # relative): further passes cannot improve. Two
                # CONSECUTIVE near-flat passes required: per-pass
                # contraction is ~eps_f32 * kappa (the f32-represented
                # correction's own residual floor), which at large kappa
                # is legitimately slow — 0.6/pass at 50M rows on the 2-D
                # Laplacian — and a single-pass 0.5 threshold killed
                # converging solves there
                break
        else:
            stalls = 0
        # scale the residual to unit norm: keeps the fp32 inner solve away
        # from under/overflow as r shrinks toward 1e-14 * |b|
        scale = jnp.float32(1.0 / max(rnorm, 1e-300))
        d2, it = inner_solve(d32, rh2, scale, diag2)
        inner_total += int(it)
        # x += d / scale, accumulated in double-single
        dh = d2 * jnp.float32(1.0 / float(scale))
        xh2, xl2 = ds_add(xh2, xl2, dh, jnp.zeros_like(dh))

    x = ds_to_f64(np.asarray(xh2).reshape(-1), np.asarray(xl2).reshape(-1))[:n]
    return RefineResult(
        x=x,
        outer_iterations=len(history) - (1 if converged else 0),
        inner_iterations=inner_total,
        rnorm=history[-1],
        converged=converged,
        history=history,
    )


def cg_refined_dist(
    a: CSRHost,
    b: np.ndarray,
    mesh=None,
    n_devices: int | None = None,
    rtol: float = 1e-12,
    max_outer: int = 8,
    inner_rtol: float = 1e-6,
    inner_kmax: int = 500,
    jacobi: bool = False,
    amg: bool | dict = False,
    local_format: str = "dia",
) -> RefineResult:
    """DISTRIBUTED mixed-precision refinement: fp32 inner CG on a sharded
    DistMatrix + double-single residuals through the sharded DS matvec
    (matvec_ds: DS halo exchange + DS kernels). Solves SPD systems to
    float64-class TRUE residual across a device mesh with zero XLA-f64
    emulation anywhere. ``local_format``: 'dia' for banded/stencil
    operators, 'well' for general sparsity (RCM-reorder first for window
    locality).

    ``amg``: precondition the fp32 inner solves with a smoothed-aggregation
    hierarchy built on the internal fp32 operator (True = auto config:
    interval2d 4x4 grid blocks + W-cycle on grid-like operators, matching
    on general ones; a dict is passed through to ``amg_setup``). This is
    the optimal-order path to f64-CLASS TRUE residuals at scale: a plain
    fp32 solve's true residual is FLOORED at ~eps_f32 * |A| |x| (just
    STORING x in f32 perturbs A x by that much — measured 3.3e-3 relative
    at 512^2, growing ~nx^2, i.e. O(1) at the 100M-row weak-scale target),
    while each refinement pass contracts toward the ~kappa * 2^-48
    double-single floor at AMG iteration counts."""
    if local_format not in ("dia", "well"):
        raise ValueError("local_format must be 'dia' or 'well'")
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a32 = build_dist_matrix(a, mesh=mesh, n_devices=n_devices,
                            dtype=np.float32, local_format=local_format)
    ads = build_dist_matrix(a, mesh=a32.mesh,
                            local_format=local_format + "_ds")
    hierarchy = None
    if amg:
        from spmv_tpu.solvers.amg import _detect_strides, amg_setup

        kw: dict = dict(local_format=local_format)
        if isinstance(amg, dict):
            kw.update(amg)
        elif _detect_strides(a):
            # grid-like operator: mesh-independent 2-D grid-block config
            # (the demo_cg --amg-aggregate auto pick)
            kw.update(aggregate="interval2d", interval_size=4, cycle=2)
        hierarchy = amg_setup(a, a32, **kw)
    n = a.nrows
    bh, bl = ds_from_f64(np.asarray(b, np.float64))
    bh_d = a32.to_dist(bh.astype(np.float32))
    bl_d = a32.to_dist(bl.astype(np.float32))
    bnorm = float(np.linalg.norm(b))

    @jax.jit
    def residual(ads_, bh_, bl_, xh, xl):
        # high plane only — see residual_ds in cg_refined for why
        yh, yl = ads_.matvec_ds(xh, xl)
        rh, _rl = ds_add(bh_, bl_, -yh, -yl)
        return rh, jnp.linalg.norm(rh)

    if hierarchy is not None:
        @jax.jit
        def inner_solve_amg(a32_, h_, rh, scale):
            """hierarchy as a jit ARGUMENT (a closure capture would embed
            its level arrays as literal program constants)."""
            res = cg(a32_.as_linear_operator(), rh * scale,
                     kmax=inner_kmax, rtol=inner_rtol,
                     preconditioner=h_.as_preconditioner())
            return res.x, res.iterations

    @jax.jit
    def inner_solve(a32_, rh, scale):
        res = cg(a32_.as_linear_operator(), rh * scale,
                 kmax=inner_kmax, rtol=inner_rtol,
                 preconditioner=(a32_.jacobi_preconditioner()
                                 if jacobi else None))
        return res.x, res.iterations

    xh = jnp.zeros_like(bh_d)
    xl = jnp.zeros_like(bh_d)
    history = []
    inner_total = 0
    converged = False
    stalls = 0
    for _ in range(max_outer):
        rh, rnorm_dev = residual(ads, bh_d, bl_d, xh, xl)
        rnorm = float(rnorm_dev)
        history.append(rnorm)
        if rnorm <= rtol * bnorm:
            converged = True
            break
        if len(history) > 1 and rnorm > 0.95 * history[-2]:
            stalls += 1
            if stalls >= 2:
                # two consecutive near-flat passes = the attainable floor
                # (~ kappa * 2^-48 relative); a slow single pass is NOT a
                # stall — contraction per pass is ~eps_f32 * kappa, 0.6 at
                # 50M rows (see cg_refined for the full rationale)
                break
        else:
            stalls = 0
        scale = jnp.float32(1.0 / max(rnorm, 1e-300))
        if hierarchy is not None:
            d, it = inner_solve_amg(a32, hierarchy, rh, scale)
        else:
            d, it = inner_solve(a32, rh, scale)
        inner_total += int(it)
        dh = d * jnp.float32(rnorm)
        xh, xl = ds_add(xh, xl, dh, jnp.zeros_like(dh))

    x = ds_to_f64(a32.from_dist(xh), a32.from_dist(xl))[:n]
    return RefineResult(
        x=x,
        outer_iterations=len(history) - (1 if converged else 0),
        inner_iterations=inner_total,
        rnorm=history[-1],
        converged=converged,
        history=history,
    )
