#!/usr/bin/env python
"""demo_spmv — distributed SpMV benchmark CLI.

Parity with the reference demo (reference demos/spmv.cpp): load or generate a
matrix, build the Gaussian-bump input, run warm-up + N SpMV applications with
per-phase timings (0.MatCreate, 1.VecCreate, 2.SpUpdate+SpMV fused — here
the halo exchange and the mult live in one compiled program, so the phases
the reference times separately are deliberately fused, 4.Copy), and report
the final vector norm as the cheap correctness signal (spmv.cpp:120-130).

Usage:
  python demos/demo_spmv.py --lap2d 1024                 # generated 2-D Laplacian
  python demos/demo_spmv.py --petsc matrix.petsc         # PETSc binary file
  python demos/demo_spmv.py --lap2d 512 --devices 8 --cpu --symmetric
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
    ap.add_argument("--iters", type=int, default=100, help="SpMV applications (reference: 100)")
    ap.add_argument("--devices", type=int, default=0, help="mesh size (0 = all)")
    ap.add_argument("--slices", type=int, default=1,
                    help="2-D (dcn, ici) mesh: --devices D split into "
                         "--slices slow-axis groups (two-tier halo plans)")
    ap.add_argument("--format", choices=["ell", "dia", "dia_ds", "well", "well_ds", "auto"],
                    default=None,
                    help="local-block format (default: ell; 'auto' selects)")
    ap.add_argument("--dia", action="store_true", help="DIA local blocks (stencil fast path)")
    ap.add_argument("--symmetric", action="store_true", help="lower-triangle storage")
    ap.add_argument("--fp32", action="store_true", help="float32 (default float64)")
    ap.add_argument("--cpu", action="store_true", help="force CPU virtual devices")
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
    from spmv_tpu.io.petsc import read_petsc_binary_matrix_host
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix
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
    n_dev = args.devices or len(jax.devices())
    mesh = None
    if args.slices > 1:
        from jax.sharding import Mesh

        devs = np.array(jax.devices()[:n_dev]).reshape(args.slices, -1)
        mesh = Mesh(devs, ("dcn", "ici"))
    A = build_dist_matrix(a, mesh=mesh, n_devices=n_dev,
                          symmetric=args.symmetric, dtype=dtype,
                          local_format=args.format or ("dia" if args.dia else "ell"))
    timer.add("0.MatCreate", time.perf_counter() - t0)

    t0 = time.perf_counter()
    x = A.to_dist(gaussian_bump(a.nrows, dtype=dtype))
    timer.add("1.VecCreate", time.perf_counter() - t0)

    print(f"matrix: {a.nrows} rows, {a.nnz} nnz, {n_dev} shard(s), "
          f"{'symmetric' if args.symmetric else 'vanilla'}, {np.dtype(dtype).name}",
          file=sys.stderr)

    # A passed as a pytree ARGUMENT (closure capture would embed the matrix
    # as literal constants in the compiled program). Iterations CHAIN
    # (y feeds the next x, scaled to avoid overflow): the dataflow dependence
    # bounds in-flight executions — un-synced independent dispatches of collective
    # programs deadlock the XLA:CPU rendezvous beyond a few dozen in flight.
    scale = dtype(0.12)
    mult = jax.jit(lambda A_, x_: A_.matvec(x_) * scale)
    y = mult(A, x)  # warm-up compile, like the reference's untimed warm-up run
    device_sync(y)

    # XLA:CPU's collective rendezvous deadlocks beyond a few dozen in-flight
    # multi-device executions (even chained) — drain the queue periodically
    # there; on an accelerator keep the dispatch pipeline deep.
    sync_every = 16 if jax.default_backend() == "cpu" else args.iters

    t0 = time.perf_counter()
    y = x
    for i in range(args.iters):
        y = mult(A, y)
        if (i + 1) % sync_every == 0:
            device_sync(y)
    device_sync(y)
    timer.add("2.SpUpdate+SpMV", time.perf_counter() - t0)

    t0 = time.perf_counter()
    y_host = A.from_dist(y)
    timer.add("4.Copy", time.perf_counter() - t0)

    print(timer.report())
    per_it = timer.acc["2.SpUpdate+SpMV"] / args.iters
    gflops = 2.0 * a.nnz / per_it / 1e9
    print(f"SpMV: {per_it * 1e3:.3f} ms/apply, {gflops:.1f} GFLOP/s")
    print(f"norm(y) = {np.linalg.norm(y_host):.12e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
