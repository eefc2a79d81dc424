#!/usr/bin/env python
"""demo_cg — distributed CG solver CLI.

Parity with the reference demo (reference demos/cg.cpp): load matrix + RHS
(or generate), solve to rtol 1e-10 within kmax 100 iterations, then verify by
independently recomputing r = A x - b and printing r.norm / x.norm /
iteration count (cg.cpp:64-96).

Usage:
  python demos/demo_cg.py --lap2d 64                       # generated problem
  python demos/demo_cg.py --petsc A.petsc --rhs b.petsc    # PETSc files
"""
from __future__ import annotations

import argparse
import sys
import time

import os
import sys


import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--petsc", help="PETSc binary matrix file")
    src.add_argument("--lap2d", type=int, help="generate NxN 2-D Laplacian")
    src.add_argument("--lap1d", type=int, help="generate N-row 1-D operator")
    src.add_argument("--lap3d", type=int, help="generate NxNxN 3-D Laplacian")
    src.add_argument("--mtx", help="Matrix Market file (.mtx / .mtx.gz)")
    ap.add_argument("--rhs", help="PETSc binary RHS vector (default: Gaussian bump)")
    ap.add_argument("--kmax", type=int, default=100, help="max iterations (reference: 100)")
    ap.add_argument("--rtol", type=float, default=1e-10, help="relative tolerance")
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--format", choices=["ell", "dia", "dia_ds", "well", "well_ds", "auto"],
                    default=None,
                    help="local-block format (default: ell; 'auto' selects)")
    ap.add_argument("--dia", action="store_true", help="DIA local blocks (stencil fast path)")
    ap.add_argument("--jacobi", action="store_true", help="Jacobi (diagonal) preconditioning")
    ap.add_argument("--spai", type=int, nargs="?", const=1, default=0,
                    metavar="LEVEL",
                    help="SPAI (sparse approximate inverse) preconditioning "
                         "for the nonsymmetric solvers; LEVEL=1 uses "
                         "pattern(A), 2 the denser pattern(|A|^2+|A|)")
    ap.add_argument("--sstep", type=int, default=0, metavar="S",
                    help="s-step (communication-avoiding) Krylov: ONE "
                         "global reduction per S iterations for CG (plain "
                         "CG pays 2-3 per iteration), 4 per S Arnoldi "
                         "steps with --solver gmres (CA-GMRES, "
                         "nonsymmetric) — the pod-scale latency lever")
    ap.add_argument("--mpk", action="store_true",
                    help="with --sstep: build the Krylov basis through "
                         "the matrix-powers kernel (depth-S ghost plan) — "
                         "ONE halo exchange + ONE reduction per S "
                         "iterations; ghost-growth stats printed")
    ap.add_argument("--newton", type=int, default=0, metavar="M",
                    help="with --sstep --solver gmres: harvest M-step "
                         "Arnoldi Ritz values once and run the Leja-"
                         "ordered NEWTON basis instead of shifted-"
                         "Chebyshev — the conditioning fix for spectra "
                         "with large imaginary extent (composes with "
                         "--mpk)")
    ap.add_argument("--fsai", action="store_true",
                    help="FSAI (factorized sparse approximate inverse) SPD "
                         "preconditioning: M^-1 = G^T G with G ~ "
                         "inv(chol(A)), apply = two SpMVs on this library's "
                         "own kernels — no triangular solves (cg/minres)")
    ap.add_argument("--deflated", type=int, default=0, metavar="D",
                    help="deflated CG: project out D approximate bottom "
                         "eigenvectors (harvested by a short LOBPCG run, "
                         "setup timed separately); the solve then converges "
                         "at the EFFECTIVE condition number lmax/l_{D+1}")
    ap.add_argument("--amg", action="store_true",
                    help="smoothed-aggregation algebraic-multigrid "
                         "preconditioning (mesh-independent iteration "
                         "counts on SPD operators; setup timed separately)")
    ap.add_argument("--amg-aggregate",
                    choices=["auto", "match", "interval", "interval2d"],
                    default="auto",
                    help="AMG aggregation: 'auto' picks interval2d (4x4 "
                         "grid blocks + W-cycle, mesh-independent, banded "
                         "coarse grids) when a grid stride is detected, "
                         "else graph matching")
    ap.add_argument("--solver", choices=["cg", "minres", "bicgstab", "gmres"],
                    default="cg",
                    help="bicgstab/gmres handle NON-symmetric operators, "
                         "minres symmetric INDEFINITE ones (the reference's "
                         "CG-only solver layer cannot touch either)")
    ap.add_argument("--refine", action="store_true",
                    help="mixed-precision iterative refinement: fp32 inner "
                         "CG + double-single residuals -> f64-class TRUE "
                         "residual (single-device, banded operators)")
    ap.add_argument("--reorder", choices=["rcm"], default=None,
                    help="bandwidth-reduction reordering before assembly "
                         "(solves the permuted SPD-equivalent system; the "
                         "printed solution is mapped back to original "
                         "numbering)")
    ap.add_argument("--symmetric", action="store_true")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    from spmv_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        import os
        if args.devices > 1:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={args.devices}"
            )
    if not args.fp32:
        jax.config.update("jax_enable_x64", True)

    from spmv_tpu.gen import create_laplace_1d, create_laplace_2d, gaussian_bump
    from spmv_tpu.io.petsc import (
        read_petsc_binary_matrix_host,
        read_petsc_binary_vector_host,
    )
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix
    from spmv_tpu.solvers.cg import cg
    from spmv_tpu.utils.timing import PhaseTimer, device_sync

    dtype = np.float32 if args.fp32 else np.float64
    timer = PhaseTimer()

    t0 = time.perf_counter()
    if args.petsc:
        a = read_petsc_binary_matrix_host(args.petsc)
    elif args.mtx:
        from spmv_tpu.io.matrix_market import read_matrix_market

        a = read_matrix_market(args.mtx)
    elif args.lap3d:
        from spmv_tpu.gen import create_laplace_3d

        a = create_laplace_3d(args.lap3d)
    elif args.lap2d:
        a = create_laplace_2d(args.lap2d, args.lap2d)
    else:
        a = create_laplace_1d(args.lap1d)
    b_host = (
        read_petsc_binary_vector_host(args.rhs).astype(dtype)
        if args.rhs
        else gaussian_bump(a.nrows, dtype=dtype)
    )
    timer.add("0.ReadPetsc", time.perf_counter() - t0)

    order = None
    if args.reorder == "rcm":
        from spmv_tpu.reorder import bandwidth, rcm_reorder

        t0 = time.perf_counter()
        b0 = bandwidth(a)
        a, order = rcm_reorder(a)
        b_host = b_host[order]
        timer.add("0.Reorder", time.perf_counter() - t0)
        print(f"RCM: bandwidth {b0} -> {bandwidth(a)}", file=sys.stderr)

    if args.refine:
        from spmv_tpu.solvers.refine import cg_refined, cg_refined_dist

        t0 = time.perf_counter()
        if (args.devices and args.devices > 1) or args.amg:
            # --refine --amg: AMG-preconditioned fp32 inner solves —
            # f64-class TRUE residuals at optimal-order iteration counts
            res = cg_refined_dist(a, b_host.astype(np.float64),
                                  n_devices=args.devices or 1,
                                  rtol=args.rtol,
                                  inner_kmax=args.kmax, jacobi=args.jacobi,
                                  amg=args.amg)
        else:
            res = cg_refined(a, b_host.astype(np.float64), rtol=args.rtol,
                             inner_kmax=args.kmax)
        timer.add("1.Solve", time.perf_counter() - t0)
        r = a.matvec(res.x) - b_host.astype(np.float64)
        print(timer.report())
        print(f"Converged: {res.converged} in {res.outer_iterations} outer / "
              f"{res.inner_iterations} inner iterations")
        print(f"r.norm = {np.linalg.norm(r):.12e}  (TRUE f64 residual)")
        print(f"x.norm = {np.linalg.norm(res.x):.12e}")
        return 0

    if args.mpk and not args.sstep:
        ap.error("--mpk builds the s-step Krylov basis; it needs --sstep S")
    if args.newton and not (args.sstep and args.solver == "gmres"):
        ap.error("--newton is the CA-GMRES Newton basis; it needs "
                 "--sstep S --solver gmres")
    if args.sstep and (args.amg or args.spai or args.fsai or args.deflated):
        ap.error("--sstep is unpreconditioned s-step CG; it cannot combine "
                 "with --amg/--spai/--fsai/--deflated")

    n_dev = args.devices or len(jax.devices())
    A = build_dist_matrix(a, n_devices=n_dev, symmetric=args.symmetric, dtype=dtype,
                          local_format=args.format or ("dia" if args.dia else "ell"))
    b = A.to_dist(b_host)
    # A passed as a pytree ARGUMENT (closure capture would embed the matrix
    # as literal constants in the compiled program)
    from spmv_tpu.solvers.bicgstab import bicgstab
    from spmv_tpu.solvers.gmres import gmres

    if args.solver == "gmres":
        def krylov(mv, bb, kmax, rtol, preconditioner):
            return gmres(mv, bb, restart=min(30, kmax),
                         max_cycles=-(-kmax // min(30, kmax)), rtol=rtol,
                         preconditioner=preconditioner)
    elif args.solver == "bicgstab":
        krylov = bicgstab
    elif args.solver == "minres":
        from spmv_tpu.solvers.minres import minres

        krylov = minres
    else:
        krylov = cg
    if args.amg:
        from spmv_tpu.solvers.amg import _detect_strides, amg_setup

        agg = args.amg_aggregate
        amg_kw = {}
        if agg == "auto":
            # grid-like operators get the headline config: 4x4 grid-block
            # aggregation + W-cycle (mesh-independent counts, banded
            # DIA-packable coarse grids); pattern-free ones graph matching
            if _detect_strides(a):
                agg, amg_kw = "interval2d", dict(interval_size=4, cycle=2)
            else:
                agg = "match"
        elif agg == "interval2d":
            amg_kw = dict(interval_size=4, cycle=2)
        t0 = time.perf_counter()
        hier = amg_setup(a, A, aggregate=agg, **amg_kw)
        timer.add("0.AMGSetup", time.perf_counter() - t0)
        print(f"AMG: {hier.n_levels} levels, grid complexity "
              f"{hier.grid_complexity():.2f}", file=sys.stderr)
        solve = jax.jit(
            lambda A_, bb, h_: krylov(
                A_.as_linear_operator(), bb, kmax=args.kmax, rtol=args.rtol,
                preconditioner=h_.as_preconditioner(),
            )
        )
        solve_args = (A, b, hier)
    elif args.fsai:
        from spmv_tpu.solvers.fsai import fsai_setup

        t0 = time.perf_counter()
        g_host = fsai_setup(a)
        # G is triangular, NOT symmetric — plain storage regardless of -s
        G = build_dist_matrix(g_host, n_devices=n_dev, dtype=dtype,
                              local_format=args.format
                              or ("dia" if args.dia else "ell"))
        Gt = G.transposed()
        timer.add("0.FSAISetup", time.perf_counter() - t0)
        solve = jax.jit(
            lambda A_, bb, G_, Gt_: krylov(
                A_.as_linear_operator(), bb, kmax=args.kmax, rtol=args.rtol,
                preconditioner=lambda r: Gt_.matvec(G_.matvec(r)),
            )
        )
        solve_args = (A, b, G, Gt)
    elif args.deflated:
        import jax.numpy as jnp

        from spmv_tpu.solvers.deflation import cg_deflated
        from spmv_tpu.solvers.lobpcg import lane_block_ops, lobpcg

        if args.solver != "cg":
            ap.error("--deflated is a CG variant; drop --solver")
        # harvest an approximate bottom-eigenvector basis: a short LOBPCG
        # run behind the Chebyshev spectral filter (plain LOBPCG stalls on
        # clustered bottoms — Laplacian gap ratios are ~1e-4); deflation
        # only needs the subspace, not converged eigenpairs
        t0 = time.perf_counter()
        from spmv_tpu.solvers.chebyshev import chebyshev_preconditioner
        from spmv_tpu.solvers.lanczos import lanczos_extreme

        _, lmax_d = lanczos_extreme(
            A.as_linear_operator(),
            A.to_dist(np.ones(a.nrows, dtype)), m=32)
        lmax = float(lmax_d) * 1.05
        deg = 16
        X0 = A.to_dist_block(np.random.default_rng(0).standard_normal(
            (a.nrows, args.deflated)).astype(dtype))
        eig = jax.jit(lambda A_, X: lobpcg(
            A_.matmat, X, k=args.deflated, maxiter=100, tol=1e-3,
            preconditioner=chebyshev_preconditioner(
                A_.matmat, (2.0 / deg) ** 2 * lmax, lmax, degree=deg),
            block_ops=lane_block_ops()))(A, X0)
        # column j of the SpMM block layout IS the single-vector lane
        # layout at lanes [j*128, (j+1)*128) — stack by device-side slicing
        # (no host round trip)
        W = jnp.stack([eig.X[:, j * 128:(j + 1) * 128]
                       for j in range(args.deflated)])
        timer.add("0.DeflSetup", time.perf_counter() - t0)
        solve = jax.jit(
            lambda A_, bb, W_: cg_deflated(
                A_.as_linear_operator(), bb, W_, kmax=args.kmax,
                rtol=args.rtol,
                preconditioner=A_.jacobi_preconditioner() if args.jacobi
                else None,
            )
        )
        solve_args = (A, b, W)
    elif args.spai:
        from spmv_tpu.solvers.spai import spai_setup

        t0 = time.perf_counter()
        m_host = spai_setup(a, pattern_level=args.spai)
        M = build_dist_matrix(m_host, n_devices=n_dev, dtype=dtype)
        timer.add("0.SPAISetup", time.perf_counter() - t0)
        solve = jax.jit(
            lambda A_, bb, M_: krylov(
                A_.as_linear_operator(), bb, kmax=args.kmax, rtol=args.rtol,
                preconditioner=M_.as_linear_operator(),
            )
        )
        solve_args = (A, b, M)
    elif args.sstep:
        from spmv_tpu.solvers.cg_sstep import cg_sstep
        from spmv_tpu.solvers.gmres_sstep import gmres_sstep

        if args.solver not in ("cg", "gmres") or args.jacobi:
            ap.error("--sstep is unpreconditioned s-step CG (or s-step "
                     "GMRES with --solver gmres); drop --solver/--jacobi")
        # --solver gmres: communication-avoiding GMRES — 4 fused
        # reductions per s Arnoldi steps (+ one deep exchange per block
        # with --mpk); falls through to the common solve/report tail
        restart = min(32, args.kmax)
        cycles = -(-args.kmax // restart)

        ritz = None
        newton_ops = None
        if args.newton:
            # one-time Ritz harvest for the Leja-Newton basis — the
            # off-axis-spectrum conditioning fix (solvers/newton_basis)
            from spmv_tpu.solvers.arnoldi import arnoldi_ritz
            from spmv_tpu.solvers.newton_basis import newton_basis_ops

            t0 = time.perf_counter()
            ritz = arnoldi_ritz(A.as_linear_operator(), b,
                                m=args.newton).values
            newton_ops = newton_basis_ops(ritz, args.sstep)
            timer.add("0.RitzHarvest", time.perf_counter() - t0)
            print(f"Newton basis: {args.newton}-step Ritz harvest, "
                  f"max |Im| = {float(abs(ritz.imag).max()):.3g}",
                  file=sys.stderr)

        def sstep_solver(mv, bb, basis_builder=None):
            if args.solver == "gmres":
                return gmres_sstep(mv, bb, s=args.sstep, restart=restart,
                                   max_cycles=cycles, rtol=args.rtol,
                                   shifts=ritz,
                                   basis_builder=basis_builder)
            return cg_sstep(mv, bb, s=args.sstep, kmax=args.kmax,
                            rtol=args.rtol, basis_builder=basis_builder)
        if args.mpk:
            from spmv_tpu.parallel.powers import (
                build_powers_plan,
                chebyshev_powers_basis,
                newton_powers_basis,
                powers_ghost_stats,
            )

            t0 = time.perf_counter()
            pp = build_powers_plan(a, A, s=args.sstep)
            timer.add("0.PowersPlan", time.perf_counter() - t0)
            st = powers_ghost_stats(pp, A)
            print(f"MPK: depth-{args.sstep} ghosts {st['nghost_pad_depth_s']}"
                  f" vs depth-1 {st['nghost_pad_depth_1']} "
                  f"(growth {st['growth']:.1f}x)", file=sys.stderr)
            if args.newton:
                solve = jax.jit(
                    lambda A_, p_, bb: sstep_solver(
                        A_.as_linear_operator(), bb,
                        basis_builder=lambda r: newton_powers_basis(
                            p_, r, newton_ops))
                )
            else:
                solve = jax.jit(
                    lambda A_, p_, bb: sstep_solver(
                        A_.as_linear_operator(), bb,
                        basis_builder=lambda r, c, e: chebyshev_powers_basis(
                            p_, r, c, e))
                )
            solve_args = (A, pp, b)
        else:
            solve = jax.jit(
                lambda A_, bb: sstep_solver(A_.as_linear_operator(), bb)
            )
            solve_args = (A, b)
    else:
        solve = jax.jit(
            lambda A_, bb: krylov(
                A_.as_linear_operator(), bb, kmax=args.kmax, rtol=args.rtol,
                preconditioner=A_.jacobi_preconditioner() if args.jacobi else None,
            )
        )
        solve_args = (A, b)
    res = solve(*solve_args)  # warm-up/compile
    device_sync(res.rnorm)  # block until compilation really finished
    t0 = time.perf_counter()
    res = solve(*solve_args)
    device_sync(res.rnorm)
    timer.add("1.Solve", time.perf_counter() - t0)

    x_host = A.from_dist(res.x)
    r = a.matvec(x_host.astype(np.float64)) - b_host.astype(np.float64)
    if order is not None:  # map the solution back to the original numbering
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        x_host = x_host[inv]

    print(timer.report())
    iters = int(res.iterations)
    print(f"Converged: {bool(res.converged)} in {iters} iterations "
          f"({iters / max(timer.acc['1.Solve'], 1e-12):.1f} it/s)")
    print(f"r.norm = {np.linalg.norm(r):.12e}")
    print(f"x.norm = {np.linalg.norm(x_host):.12e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
