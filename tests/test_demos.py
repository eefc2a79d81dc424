"""CLI surface tests: run the demo programs as real subprocesses (the demos
are the reference's L8 layer; the reference never tested its demos)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_demo(args, timeout=240):
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable] + args, capture_output=True, text=True,
        timeout=timeout, cwd=REPO, env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_demo_spmv_cli():
    stdout = run_demo(
        ["demos/demo_spmv.py", "--lap2d", "24", "--cpu", "--devices", "2",
         "--iters", "3"]
    )
    assert "2.SpUpdate+SpMV" in stdout
    assert "norm(y)" in stdout


def test_demo_cg_cli_converges():
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--symmetric"]
    )
    assert "Converged: True" in stdout
    rnorm = float(stdout.split("r.norm = ")[1].split()[0])
    assert rnorm < 1e-8


def test_demo_cg_petsc_file(tmp_path):
    """Full PETSc-file flow through the CLI (BASELINE config 3 shape):
    write matrix + rhs, solve, check the printed residual."""
    from spmv_tpu.gen import create_laplace_2d, gaussian_bump
    from spmv_tpu.io.petsc import (
        write_petsc_binary_matrix,
        write_petsc_binary_vector,
    )

    a = create_laplace_2d(12, 12)
    mpath = str(tmp_path / "A.petsc")
    vpath = str(tmp_path / "b.petsc")
    write_petsc_binary_matrix(mpath, a)
    write_petsc_binary_vector(vpath, gaussian_bump(a.nrows))
    stdout = run_demo(
        ["demos/demo_cg.py", "--petsc", mpath, "--rhs", vpath, "--cpu",
         "--devices", "2", "--kmax", "300"]
    )
    assert "Converged: True" in stdout


def test_demo_restrict_cli():
    stdout = run_demo(["demos/demo_restrict.py", "--n", "256", "--cpu"])
    assert "verified against dense oracle" in stdout


def test_bench_json_shape(capsys):
    """bench.py's contract: ONE JSON line naming the device, with every
    cell present. ``--smoke`` runs the real code at tiny sizes on the CPU
    and reports no time or rate."""
    sys.path.insert(0, REPO)
    import bench

    assert bench.main(["--smoke", "--no-corpus"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["device"]["platform"] == "cpu" and out["smoke"] is True
    cells = out["cells"]
    assert {"lap2d_dia_vanilla", "lap2d_dia_symmetric", "lap2d_dia_matmat8",
            "banded_random_4M", "lap2d_solvers"} <= set(cells)
    assert cells["banded_random_4M"]["format"] == "well"
    assert "ms_per_apply" not in json.dumps(cells)
    with pytest.raises(KeyError, match="no published peak"):
        bench.hbm_peak_gbs("cpu")


def test_demo_cg_mtx_file(tmp_path):
    """Matrix Market input through the CLI."""
    from spmv_tpu.gen import create_laplace_2d
    from spmv_tpu.io.matrix_market import write_matrix_market

    a = create_laplace_2d(10, 10)
    p = str(tmp_path / "A.mtx")
    write_matrix_market(p, a)
    stdout = run_demo(
        ["demos/demo_cg.py", "--mtx", p, "--cpu", "--devices", "2",
         "--kmax", "200"]
    )
    assert "Converged: True" in stdout


def test_demo_cg_bicgstab_solver():
    """--solver bicgstab through the CLI (non-symmetric-capable path; the
    Laplacian is symmetric so both solvers must agree on the solution)."""
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--solver", "bicgstab"]
    )
    assert "Converged: True" in stdout
    rnorm = float(stdout.split("r.norm = ")[1].split()[0])
    assert rnorm < 1e-8


def test_demo_cg_gmres_solver():
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--solver", "gmres"]
    )
    assert "Converged: True" in stdout
    assert float(stdout.split("r.norm = ")[1].split()[0]) < 1e-8


def test_demo_cg_spai_preconditioner():
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--solver", "gmres", "--spai", "--kmax", "400", "--rtol", "1e-8"])
    assert "Converged: True" in stdout
    rnorm = float(stdout.split("r.norm = ")[1].split()[0])
    assert rnorm < 1e-5


def test_demo_cg_fsai_preconditioner():
    """--fsai through the CLI: SPD-preconditioned CG must converge in
    FEWER iterations than plain (79 vs 123 on this family) and hit the
    same solution."""
    plain = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--kmax", "200"])
    fsai = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--fsai", "--kmax", "200"])
    assert "Converged: True" in fsai
    assert float(fsai.split("r.norm = ")[1].split()[0]) < 1e-8
    it_plain = int(plain.split("Converged: True in ")[1].split()[0])
    it_fsai = int(fsai.split("Converged: True in ")[1].split()[0])
    assert it_fsai < it_plain
    x_plain = float(plain.split("x.norm = ")[1].split()[0])
    x_fsai = float(fsai.split("x.norm = ")[1].split()[0])
    np.testing.assert_allclose(x_fsai, x_plain, rtol=1e-8)


def test_demo_cg_deflated():
    """--deflated D through the CLI: LOBPCG-harvested basis + deflated CG
    converges, matching the plain solution."""
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--deflated", "4", "--kmax", "200"])
    assert "0.DeflSetup" in stdout
    assert "Converged: True" in stdout
    assert float(stdout.split("r.norm = ")[1].split()[0]) < 1e-8


def test_demo_eig_svd_triplets():
    """--svd through the CLI: Golub-Kahan top triplets of the 2-D
    Laplacian; sigma_max(16x16 lap2d) is 4*(cos(pi/17)+... ) ~ 7.86 — check
    the printed leading sigma against the dense value and the certificate
    column is present."""
    stdout = run_demo(
        ["demos/demo_eig.py", "--lap2d", "16", "--svd", "40", "-k", "2",
         "--cpu", "--devices", "2"])
    assert "largest singular triplets" in stdout
    s0 = float(stdout.split("sigma[0] = ")[1].split()[0])
    # dense check: lap2d eigenvalues are 4 - 2cos(i pi/17) - 2cos(j pi/17)
    th = np.pi / 17.0
    want = 4.0 - 2.0 * np.cos(16 * th) - 2.0 * np.cos(16 * th)
    np.testing.assert_allclose(s0, want, rtol=1e-6)
    assert "|A^T u - s v|" in stdout


def test_demo_cg_sstep():
    """--sstep S through the CLI: communication-avoiding CG converges to
    the same solution as plain CG (within block-granularity iterations)."""
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--sstep", "4", "--kmax", "200"])
    assert "Converged: True" in stdout
    assert float(stdout.split("r.norm = ")[1].split()[0]) < 1e-8


def test_demo_cg_sstep_mpk():
    """--sstep S --mpk: matrix-powers-kernel basis through the CLI; same
    solution as plain CG, ghost stats printed."""
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--sstep", "4", "--mpk", "--kmax", "200"])
    assert "Converged: True" in stdout
    assert float(stdout.split("r.norm = ")[1].split()[0]) < 1e-8


def test_demo_cg_sstep_gmres():
    """--sstep S --solver gmres (+ --mpk): communication-avoiding GMRES
    through the CLI converges on the SPD demo operator."""
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--sstep", "4", "--solver", "gmres", "--mpk", "--kmax", "200"])
    assert "Converged: True" in stdout
    assert float(stdout.split("r.norm = ")[1].split()[0]) < 1e-7


def test_demo_cg_sstep_gmres_newton():
    """--sstep S --solver gmres --newton M (+ --mpk): CA-GMRES on the
    Leja-Newton basis from an M-step Ritz harvest, end-to-end through
    the CLI — converges, harvest line printed."""
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "16", "--cpu", "--devices", "2",
         "--sstep", "4", "--solver", "gmres", "--newton", "16", "--mpk",
         "--kmax", "200"])
    assert "Converged: True" in stdout
    assert float(stdout.split("r.norm = ")[1].split()[0]) < 1e-7


def test_demo_eig_slq_logdet():
    """--logdet through the CLI: the SLQ estimate must land within its own
    Monte-Carlo error bars of the dense slogdet (deterministic seed)."""
    stdout = run_demo(
        ["demos/demo_eig.py", "--lap2d", "16", "--logdet", "48",
         "--probes", "24", "--cpu", "--devices", "2"])
    assert "log det A = " in stdout and "exact (dense slogdet)" in stdout
    dev = float(stdout.split("deviation = ")[1].split()[0])
    assert dev < 4.0


def test_demo_eig_arnoldi_nonsymmetric():
    stdout = run_demo(
        ["demos/demo_eig.py", "--convdiff", "16", "--arnoldi", "40",
         "-k", "2", "--cpu", "--devices", "2"])
    assert "spectral radius" in stdout
    rho = float(stdout.split("spectral radius >= ")[1].split(",")[0])
    # 16x16 convection-diffusion: rho ~ 4 + 2*... around 8-9
    assert 6.0 < rho < 12.0


def test_demo_cg_refine_amg_cli():
    """--refine --amg: AMG-preconditioned mixed-precision refinement
    through the CLI — TRUE f64-class residual printed and small."""
    stdout = run_demo(
        ["demos/demo_cg.py", "--lap2d", "48", "--cpu", "--devices", "2",
         "--refine", "--amg", "--rtol", "1e-10", "--kmax", "100"]
    )
    assert "TRUE f64 residual" in stdout
    rnorm = float(stdout.split("r.norm = ")[1].split()[0])
    assert rnorm < 1e-8
