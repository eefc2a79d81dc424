#!/usr/bin/env python
"""End-to-end proof that spmv_tpu's main path runs on an NVIDIA GPU.

    python chip_smoke.py                # one card, full size
    python chip_smoke.py --four-cards   # the 4-card distributed phase only
    python chip_smoke.py --nx 512       # one card, a smaller grid

Drives the library through its normal entry points (``build_dist_matrix``
-> ``DistMatrix`` -> solvers) on the 2-D Laplacian at 3200^2 = 10.24M
rows, plus the ``fem2d`` corpus matrix (800k rows) for general sparsity.
Every phase prints one line with its error against the plain float64 host
reference (``CSRHost.matvec``) beside its tolerance, and its time. Any
failed check raises, so the script exits non-zero. Without a GPU it exits
with code 2 and prints no result. The last line of standard output is one
JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from bench import (card_facts, copy_rate_gbs, hbm_peak_gbs, moved_bytes,
                   row_abs_max, seconds_per_apply)

F32 = np.float32
F64 = np.float64


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def rel_err(got, want) -> float:
    got = np.asarray(got, F64)
    want = np.asarray(want, F64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def report(phase: str, name: str, **fields) -> None:
    text = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {name}: {text}", flush=True)


def check(phase: str, name: str, err: float, tol: float, **fields) -> None:
    """Print the phase line; raise when the error misses its tolerance."""
    report(phase, name, err=f"{err:.3e}", tol=f"{tol:.0e}", **fields)
    if not (np.isfinite(err) and err <= tol):
        raise AssertionError(f"[{phase}] {name}: error {err:.3e} > {tol:.0e}")


def solve_floor(a, x, b) -> float:
    """The true relative residual float32 storage of ``x`` alone can
    explain: eps32 * ||A||_inf * ||x|| / ||b||."""
    return float(np.finfo(F32).eps * row_abs_max(a) * np.linalg.norm(x)
                 / max(np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------------------
# phases (each takes its sizes; the tests run them tiny on the CPU mesh)
# ---------------------------------------------------------------------------


def phase_dia_f32(nx: int, peak_gbs: float | None, copy_gbs: float | None,
                  k: int = 50) -> dict:
    """1. DIA SpMV at f32, vanilla and symmetric storage."""
    import jax

    from spmv_tpu.gen import create_laplace_2d
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(nx, nx, dtype=F32)
    x = np.random.default_rng(1).standard_normal(a.nrows).astype(F32)
    want = a.matvec(x.astype(F64))
    out = {"a": a}
    for symmetric in (False, True):
        tag = "symmetric" if symmetric else "vanilla"
        t0 = time.perf_counter()
        A = build_dist_matrix(a, n_devices=1, local_format="dia", dtype=F32,
                              symmetric=symmetric)
        xd = A.to_dist(x)
        f = jax.jit(lambda A_, v: A_.matvec(v))
        y = A.from_dist(f(A, xd))
        sec = seconds_per_apply(lambda A_, u: A_.matvec(u) * F32(0.125),
                                A, xd, k)
        nbytes = moved_bytes(A)
        fields = dict(ms_per_apply=f"{sec * 1e3:.4f}",
                      gbs=f"{nbytes / sec / 1e9:.1f}")
        if peak_gbs:
            fields["share_of_peak"] = f"{nbytes / sec / 1e9 / peak_gbs:.3f}"
        if copy_gbs:
            fields["share_of_copy"] = f"{nbytes / sec / 1e9 / copy_gbs:.3f}"
        fields["t_s"] = f"{time.perf_counter() - t0:.1f}"
        check("1", f"dia-f32-{tag} n={a.nrows}", rel_err(y, want), 2e-6,
              **fields)
        mem = f.lower(A, xd).compile().memory_analysis()
        report("1", f"dia-f32-{tag} memory_analysis", value=str(mem))
        out[tag] = A
        out[f"{tag}_ms"] = sec * 1e3
    return out


def phase_dia_f64(nx: int, k: int = 50) -> dict:
    """2. DIA SpMV at native f64, and the double-single apply."""
    import jax

    from spmv_tpu.ds import ds_from_f64
    from spmv_tpu.gen import create_laplace_2d
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    a = create_laplace_2d(nx, nx, dtype=F64)
    x = np.random.default_rng(2).standard_normal(a.nrows)
    want = a.matvec(x)
    t0 = time.perf_counter()
    A = build_dist_matrix(a, n_devices=1, local_format="dia", dtype=F64)
    xd = A.to_dist(x)
    y = A.from_dist(jax.jit(lambda A_, v: A_.matvec(v))(A, xd))
    sec64 = seconds_per_apply(lambda A_, u: A_.matvec(u) * 0.125, A, xd, k)
    check("2", f"dia-f64 n={a.nrows}", rel_err(y, want), 1e-13,
          ms_per_apply=f"{sec64 * 1e3:.4f}",
          t_s=f"{time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    Ads = build_dist_matrix(a, n_devices=1, local_format="dia_ds")
    xh, xl = ds_from_f64(x)
    xhd, xld = Ads.to_dist(xh), Ads.to_dist(xl)
    yh, yl = jax.jit(lambda A_, h, l: A_.matvec_ds(h, l))(Ads, xhd, xld)
    y_ds = Ads.from_dist(yh).astype(F64) + Ads.from_dist(yl).astype(F64)

    def ds_step(A_, u):
        h, l = A_.matvec_ds(*u)
        return h * F32(0.125), l * F32(0.125)

    sec_ds = seconds_per_apply(ds_step, Ads, (xhd, xld), k)
    check("2", f"dia-ds n={a.nrows}", rel_err(y_ds, want), 1e-12,
          ms_per_apply=f"{sec_ds * 1e3:.4f}",
          ds_over_f64=f"{sec_ds / sec64:.3f}",
          t_s=f"{time.perf_counter() - t0:.1f}")
    return {"a": a, "A": A, "f64_ms": sec64 * 1e3, "ds_ms": sec_ds * 1e3}


def phase_general(n_nodes: int, k: int = 30) -> dict:
    """3. General sparsity: fem2d -> RCM -> auto (WELL) and ELL at f32."""
    import jax

    from spmv_tpu.corpus import fem_p1_2d
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix
    from spmv_tpu.reorder import rcm_reorder

    t0 = time.perf_counter()
    a, _ = rcm_reorder(fem_p1_2d(n_nodes=n_nodes), keep_best=True)
    scale = F32(1.0 / row_abs_max(a))
    x = np.random.default_rng(3).standard_normal(a.nrows).astype(F32)
    want = a.matvec(x.astype(F64))
    report("3", f"fem2d n={a.nrows} nnz={a.nnz}",
           host_setup_s=f"{time.perf_counter() - t0:.1f}")
    out = {"a": a}
    for fmt in ("auto", "ell"):
        t0 = time.perf_counter()
        A = build_dist_matrix(a, n_devices=1, local_format=fmt, dtype=F32)
        xd = A.to_dist(x)
        y = A.from_dist(jax.jit(lambda A_, v: A_.matvec(v))(A, xd))
        sec = seconds_per_apply(lambda A_, u: A_.matvec(u) * scale, A, xd, k)
        check("3", f"fem2d-{fmt}->{A.local_format}", rel_err(y, want), 1e-5,
              ms_per_apply=f"{sec * 1e3:.4f}",
              stored_mb=f"{A.format_size_bytes() / 1e6:.1f}",
              t_s=f"{time.perf_counter() - t0:.1f}")
        out[fmt] = A
        out[f"{fmt}_ms"] = sec * 1e3
    return out


def phase_block(dia_a, dia_A, gen_a, gen_A, nrhs: int = 8,
                k: int = 20) -> None:
    """4. Block apply (matmat) at nrhs=8 for DIA and WELL against the host
    product, and its time against nrhs single applies."""
    import jax

    for tag, a, A in (("dia", dia_a, dia_A), ("well", gen_a, gen_A)):
        t0 = time.perf_counter()
        X = np.random.default_rng(4).standard_normal(
            (a.nrows, nrhs)).astype(F32)
        want = np.stack([a.matvec(X[:, r].astype(F64)) for r in range(nrhs)],
                        axis=1)
        xb = A.to_dist_block(X)
        Y = A.from_dist_block(jax.jit(lambda A_, v: A_.matmat(v))(A, xb))
        scale = F32(1.0 / row_abs_max(a))
        sec_blk = seconds_per_apply(lambda A_, u: A_.matmat(u) * scale,
                                    A, xb, k)
        sec_one = seconds_per_apply(lambda A_, u: A_.matvec(u) * scale,
                                    A, A.to_dist(X[:, 0]), k)
        check("4", f"matmat-{tag}({A.local_format}) nrhs={nrhs}",
              rel_err(Y, want), 1e-5,
              ms_per_block=f"{sec_blk * 1e3:.4f}",
              block_over_nrhs_matvecs=f"{sec_blk / (nrhs * sec_one):.3f}",
              t_s=f"{time.perf_counter() - t0:.1f}")


def phase_solves(a32, A32, a64, A64, amg_kw: dict, refine: bool = True) -> None:
    """5. Solves: plain CG (f32), CG at native f64, AMG-PCG (f32), and
    AMG-preconditioned refinement to a float64-class true residual."""
    import jax

    from spmv_tpu.gen import gaussian_bump
    from spmv_tpu.solvers.amg import amg_setup
    from spmv_tpu.solvers.cg import cg
    from spmv_tpu.solvers.refine import cg_refined_dist

    n = a32.nrows
    b32 = gaussian_bump(n, dtype=F32)

    t0 = time.perf_counter()
    bd = A32.to_dist(b32)
    res = jax.jit(lambda A_, b_: cg(A_.as_linear_operator(), b_, kmax=50,
                                    rtol=0.0))(A32, bd)
    x = A32.from_dist(res.x)
    host = rel_err(a32.matvec(x.astype(F64)), b32)
    reported = float(res.rnorm) / float(res.rnorm0)
    check("5", "cg-f32 kmax=50 |host-reported|", abs(host - reported), 1e-3,
          host_rel=f"{host:.4e}", reported_rel=f"{reported:.4e}",
          t_s=f"{time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    b64 = gaussian_bump(n)
    solve64 = jax.jit(lambda A_, b_: cg(A_.as_linear_operator(), b_,
                                        kmax=40_000, rtol=1e-8))
    bd64 = A64.to_dist(b64)
    jax.block_until_ready(solve64(A64, bd64))
    t1 = time.perf_counter()
    r64 = jax.block_until_ready(solve64(A64, bd64))
    solve_s = time.perf_counter() - t1
    x64 = A64.from_dist(r64.x)
    check("5", "cg-f64 rtol=1e-8 true_rel", rel_err(a64.matvec(x64), b64),
          1e-7, iterations=int(r64.iterations),
          converged=bool(r64.converged), solve_s=f"{solve_s:.3f}",
          t_s=f"{time.perf_counter() - t0:.1f}")

    t0 = time.perf_counter()
    h = amg_setup(a32, A32, **amg_kw)
    setup_s = time.perf_counter() - t0
    pcg = jax.jit(lambda A_, b_, h_: cg(
        A_.as_linear_operator(), b_, kmax=200, rtol=1e-6,
        preconditioner=h_.as_preconditioner()))
    jax.block_until_ready(pcg(A32, bd, h))
    t1 = time.perf_counter()
    rp = jax.block_until_ready(pcg(A32, bd, h))
    solve_s = time.perf_counter() - t1
    xp = A32.from_dist(rp.x)
    host = rel_err(a32.matvec(xp.astype(F64)), b32)
    reported = float(rp.rnorm) / float(rp.rnorm0)
    floor = solve_floor(a32, xp, b32)
    if not bool(rp.converged):
        raise AssertionError("[5] amg-pcg did not converge")
    check("5", "amg-pcg-f32 |host-reported| vs f32 storage floor",
          abs(host - reported), max(1e-3, 2 * floor),
          levels=h.n_levels, iterations=int(rp.iterations),
          host_rel=f"{host:.4e}", reported_rel=f"{reported:.4e}",
          setup_s=f"{setup_s:.1f}", solve_s=f"{solve_s:.3f}")

    if refine:
        t0 = time.perf_counter()
        rr = cg_refined_dist(a64, b64, n_devices=1, rtol=1e-10,
                             inner_kmax=200, amg=amg_kw)
        check("5", "cg_refined_dist(amg) true_rel",
              rel_err(a64.matvec(rr.x), b64), 1e-8,
              outer=rr.outer_iterations, inner=rr.inner_iterations,
              t_s=f"{time.perf_counter() - t0:.1f}")


def phase_four_cards(nx: int) -> None:
    """Distributed path on a 1-D mesh over four GPUs in one process."""
    import jax
    from jax.sharding import Mesh

    from spmv_tpu.gen import create_laplace_2d, gaussian_bump
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix
    from spmv_tpu.solvers.amg import amg_setup
    from spmv_tpu.solvers.cg import cg
    from spmv_tpu.utils.hlo import halo_bracket, interior_products_independent

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 devices, found {len(devs)}")
    mesh = Mesh(np.array(devs[:4]), ("shards",))
    t0 = time.perf_counter()
    a = create_laplace_2d(nx, nx, dtype=F32)
    x = np.random.default_rng(5).standard_normal(a.nrows).astype(F32)
    want = a.matvec(x.astype(F64))
    report("4c", f"lap2d n={a.nrows} per_card={a.nrows // 4}",
           host_setup_s=f"{time.perf_counter() - t0:.1f}")
    for symmetric in (False, True):
        tag = "symmetric" if symmetric else "vanilla"
        t0 = time.perf_counter()
        A4 = build_dist_matrix(a, mesh=mesh, local_format="dia", dtype=F32,
                               symmetric=symmetric)
        A1 = build_dist_matrix(a, n_devices=1, local_format="dia", dtype=F32,
                               symmetric=symmetric)
        f = jax.jit(lambda A_, v: A_.matvec(v))
        x4, x1 = A4.to_dist(x), A1.to_dist(x)
        y4 = A4.from_dist(f(A4, x4))
        y1 = A1.from_dist(f(A1, x1))
        step = lambda A_, u: A_.matvec(u) * F32(0.125)  # noqa: E731
        s4 = seconds_per_apply(step, A4, x4, 20)
        s1 = seconds_per_apply(step, A1, x1, 20)
        check("4c", f"dia-f32-{tag} 4 cards vs host", rel_err(y4, want),
              2e-6, ms_4cards=f"{s4 * 1e3:.4f}", ms_1card=f"{s1 * 1e3:.4f}",
              speedup=f"{s1 / s4:.2f}", rounds=A4.plan.rounds,
              t_s=f"{time.perf_counter() - t0:.1f}")
        check("4c", f"dia-f32-{tag} 4 cards vs 1 card", rel_err(y4, y1), 2e-6)
        text = f.lower(A4, x4).compile().as_text()
        dep = interior_products_independent(text, "local_dia_data")
        br = halo_bracket(text, "local_dia_data")
        report("4c", f"schedule-{tag}",
               interior_products=len(dep),
               interior_reads_halo=any(d for _, d in dep), **br)
        del A1

    t0 = time.perf_counter()
    a64 = create_laplace_2d(nx, nx, dtype=F64)
    A64 = build_dist_matrix(a64, mesh=mesh, local_format="dia", dtype=F64)
    b64 = gaussian_bump(a64.nrows)
    r = jax.jit(lambda A_, b_: cg(A_.as_linear_operator(), b_, kmax=20,
                                  rtol=0.0))(A64, A64.to_dist(b64))
    host = rel_err(a64.matvec(A64.from_dist(r.x)), b64)
    reported = float(r.rnorm) / float(r.rnorm0)
    check("4c", "cg-f64 kmax=20 |host-reported|", abs(host - reported), 1e-9,
          host_rel=f"{host:.4e}", t_s=f"{time.perf_counter() - t0:.1f}")
    del A64, a64

    t0 = time.perf_counter()
    A = build_dist_matrix(a, mesh=mesh, local_format="dia", dtype=F32)
    h = amg_setup(a, A, aggregate="interval2d", interval_size=4, cycle=2,
                  local_format="dia")
    setup_s = time.perf_counter() - t0
    b = gaussian_bump(a.nrows, dtype=F32)
    bd = A.to_dist(b)
    pcg = jax.jit(lambda A_, b_, h_: cg(
        A_.as_linear_operator(), b_, kmax=200, rtol=1e-6,
        preconditioner=h_.as_preconditioner()))
    jax.block_until_ready(pcg(A, bd, h))
    t1 = time.perf_counter()
    rp = jax.block_until_ready(pcg(A, bd, h))
    solve_s = time.perf_counter() - t1
    xp = A.from_dist(rp.x)
    host = rel_err(a.matvec(xp.astype(F64)), b)
    reported = float(rp.rnorm) / float(rp.rnorm0)
    if not bool(rp.converged):
        raise AssertionError("[4c] amg-pcg did not converge")
    check("4c", "amg-pcg-f32 |host-reported| vs f32 storage floor",
          abs(host - reported), max(1e-3, 2 * solve_floor(a, xp, b)),
          levels=h.n_levels, iterations=int(rp.iterations),
          setup_s=f"{setup_s:.1f}", solve_s=f"{solve_s:.3f}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card distributed phase")
    ap.add_argument("--nx", type=int, default=None,
                    help="grid side (default 3200; 6400 with --four-cards)")
    ap.add_argument("--fem-nodes", type=int, default=800_000)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2

    from spmv_tpu.utils.runtime import setup_compile_cache

    cache = setup_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    report("0", "device", platform=devs[0].platform,
           kind=repr(devs[0].device_kind), count=len(devs))
    report("0", "software", jax=jax.__version__,
           xla_flags=repr(os.environ.get("XLA_FLAGS", "")),
           compile_cache=cache)
    print(card_facts(), flush=True)
    peak = hbm_peak_gbs(devs[0].device_kind)
    t_start = time.perf_counter()

    if args.four_cards:
        phase_four_cards(args.nx or 6400)
    else:
        nx = args.nx or 3200
        copy = copy_rate_gbs()
        report("0", "copy", gbs=f"{copy:.1f}",
               share_of_peak=f"{copy / peak:.3f}", peak_gbs=peak)
        p1 = phase_dia_f32(nx, peak, copy)
        p2 = phase_dia_f64(nx)
        p3 = phase_general(args.fem_nodes)
        phase_block(p1["a"], p1["vanilla"], p3["a"], p3["auto"])
        phase_solves(p1["a"], p1["vanilla"], p2["a"], p2["A"],
                     dict(aggregate="interval2d", interval_size=4, cycle=2,
                          local_format="dia"))
    report("end", "all phases passed",
           total_s=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
