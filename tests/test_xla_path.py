"""The compiled SpMV paths are plain XLA on every format, their float32
products run at full precision, and the programs that drive the library
(chip_smoke.py, the compile-cache helper) behave as documented."""
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.gen import create_laplace_2d, random_csr
from spmv_tpu.parallel.dist_matrix import build_dist_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

KERNEL_CALL = re.compile(
    r'custom_call_target="[^"]*(mosaic|pallas|triton|tpu)', re.I)


def _mesh4():
    return Mesh(np.array(jax.devices()[:4]), ("shards",))


def _host_matrix(fmt: str) -> CSRHost:
    if fmt in ("ell", "dia", "dia_ds"):
        return create_laplace_2d(32, 32)
    a = random_csr(2048, 2048, 5, seed=3, symmetric=True, spd_shift=1.0)
    return a


def _build(fmt: str, symmetric: bool):
    a = _host_matrix(fmt)
    dtype = None if fmt.endswith("_ds") else np.float32
    A = build_dist_matrix(a, mesh=_mesh4(), local_format=fmt, dtype=dtype,
                          symmetric=symmetric)
    return a, A


def _compiled_text(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("fmt", ["ell", "dia", "well"])
@pytest.mark.parametrize("method", ["matvec", "matmat"])
def test_no_kernel_custom_call(method, fmt, symmetric):
    """matvec/matmat compile to XLA ops only (no Pallas/Mosaic/Triton
    custom call) and still match the host product."""
    a, A = _build(fmt, symmetric)
    assert A.local_format == fmt
    rng = np.random.default_rng(0)
    if method == "matvec":
        xh = rng.standard_normal(a.nrows).astype(np.float32)
        x = A.to_dist(xh)
        f = lambda A_, v: A_.matvec(v)  # noqa: E731
        want = a.matvec(xh.astype(np.float64))
        got = lambda y: A.from_dist(y)  # noqa: E731
    else:
        xh = rng.standard_normal((a.nrows, 3)).astype(np.float32)
        x = A.to_dist_block(xh)
        f = lambda A_, v: A_.matmat(v)  # noqa: E731
        want = np.stack([a.matvec(xh[:, r].astype(np.float64))
                         for r in range(3)], axis=1)
        got = lambda y: A.from_dist_block(y)  # noqa: E731
    text = _compiled_text(f, A, x)
    assert not KERNEL_CALL.search(text)
    y = got(jax.jit(f)(A, x))
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-5


@pytest.mark.parametrize("fmt,symmetric,method", [
    ("dia_ds", False, "matvec_ds"),
    ("dia_ds", False, "matmat_ds"),
    ("well_ds", False, "matvec_ds"),
    ("well_ds", False, "matmat_ds"),
    ("well_ds", True, "matvec_ds"),
])
def test_no_kernel_custom_call_ds(fmt, symmetric, method):
    """The double-single applies compile to XLA ops only and keep their
    float64-class accuracy."""
    from spmv_tpu.ds import ds_from_f64

    a, A = _build(fmt, symmetric)
    rng = np.random.default_rng(1)
    if method == "matvec_ds":
        xv = rng.standard_normal(a.nrows)
        hi, lo = ds_from_f64(xv)
        xh, xl = A.to_dist(hi), A.to_dist(lo)
        want = a.matvec(xv)
        back = A.from_dist
    else:
        xv = rng.standard_normal((a.nrows, 2))
        hi, lo = ds_from_f64(xv)
        xh, xl = A.to_dist_block(hi), A.to_dist_block(lo)
        want = np.stack([a.matvec(xv[:, r]) for r in range(2)], axis=1)
        back = A.from_dist_block
    f = getattr(type(A), method)
    text = _compiled_text(f, A, xh, xl)
    assert not KERNEL_CALL.search(text)
    yh, yl = jax.jit(f)(A, xh, xl)
    y = back(yh).astype(np.float64) + back(yl).astype(np.float64)
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-12


def _eqns(fn, *args, name: str):
    """Every equation of primitive ``name`` in fn's jaxpr, nested included."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == name:
                found.append(eqn)
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _dot_precisions(fn, *args):
    return [e.params["precision"]
            for e in _eqns(fn, *args, name="dot_general")]


@pytest.mark.parametrize("fmt", ["dia", "well"])
def test_symmetric_ghost_transpose_is_a_gather(fmt):
    """Symmetric operators send their ghost-column contributions back from
    the transposed remote block, one gather per ghost slot: no scatter-add
    runs over the shard's rows, whose padding slots would all add onto
    ghost 0 (atomics that serialise on a GPU)."""
    a, A = _build(fmt, True)
    assert A.plan.nghost_pad > 0 and A.remoteT_colind is not None
    x = A.to_dist(np.ones(a.nrows, np.float32))
    adds = _eqns(lambda A_, v: A_.matvec(v), A, x, name="scatter-add")
    n_updates = [int(np.prod(e.invars[1].aval.shape[:-1])) for e in adds]
    assert n_updates and max(n_updates) < A.row_pad, n_updates


@pytest.mark.parametrize("method", ["matvec", "matmat"])
@pytest.mark.parametrize("fmt", ["ell", "dia", "well"])
def test_f32_einsums_highest_precision(fmt, method):
    """Every f32 dot_general of the local ELL and remote-ghost products
    (single and block) asks for HIGHEST: a TF32 product would keep only
    about three decimal digits."""
    a, A = _build(fmt, False)
    x = (A.to_dist(np.ones(a.nrows, np.float32)) if method == "matvec"
         else A.to_dist_block(np.ones((a.nrows, 2), np.float32)))
    precs = _dot_precisions(lambda A_, v: getattr(A_, method)(v), A, x)
    assert precs, "expected the ghost (and ELL local) einsums"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precs), precs


def test_solver_products_highest_precision():
    """Krylov dots, Gram and projection products trace at HIGHEST."""
    from spmv_tpu.solvers.block_cg import block_cg
    from spmv_tpu.solvers.cg import cg
    from spmv_tpu.solvers.gmres import gmres
    from spmv_tpu.solvers.lobpcg import lobpcg

    op = lambda v: 2.0 * v  # noqa: E731
    b = jnp.ones((4, 128), jnp.float32)
    hi = jax.lax.Precision.HIGHEST
    for fn in (lambda v: cg(op, v, kmax=3).x,
               lambda v: gmres(op, v, restart=3, max_cycles=1).x,
               lambda v: block_cg(op, jnp.tile(v, (1, 2)), 2, kmax=3).x,
               lambda v: lobpcg(op, jnp.ones((512, 2), jnp.float32),
                                maxiter=2).eigenvalues):
        precs = _dot_precisions(fn, b)
        assert precs and all(p == (hi, hi) for p in precs), precs


# ----- compile-cache helper -----


def test_compile_cache_default_dir(monkeypatch, tmp_path):
    from spmv_tpu.utils.runtime import CACHE_ENV, setup_compile_cache

    monkeypatch.delenv(CACHE_ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = setup_compile_cache(str(tmp_path))
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_sets_nothing(monkeypatch, tmp_path):
    from spmv_tpu.utils.runtime import CACHE_ENV, setup_compile_cache

    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "elsewhere"))
    before = jax.config.jax_compilation_cache_dir
    assert setup_compile_cache(str(tmp_path)) == str(tmp_path / "elsewhere")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_ignored_checkout_dir():
    from spmv_tpu.utils.runtime import checkout_root

    assert os.path.samefile(checkout_root(), REPO)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ----- chip_smoke.py phases at tiny sizes on the CPU -----


def test_chip_smoke_main_fails_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no GPU" in out.err


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo the script fails and prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_dia_phases_tiny(capsys):
    p1 = chip_smoke.phase_dia_f32(32, None, None, k=2)
    p2 = chip_smoke.phase_dia_f64(32, k=2)
    out = capsys.readouterr().out
    assert "dia-f32-vanilla" in out and "dia-f32-symmetric" in out
    assert "dia-ds" in out and p2["A"].local_format == "dia"
    assert p1["vanilla"].local_format == "dia"


def test_chip_smoke_general_and_block_tiny(capsys):
    p1 = chip_smoke.phase_dia_f32(32, None, None, k=2)
    p3 = chip_smoke.phase_general(2000, k=2)
    assert p3["auto"].local_format == "well"
    chip_smoke.phase_block(p1["a"], p1["vanilla"], p3["a"], p3["auto"],
                           nrhs=3, k=2)
    assert "matmat-well(well)" in capsys.readouterr().out


def test_chip_smoke_solves_tiny(capsys):
    a32 = create_laplace_2d(48, 48, dtype=np.float32)
    a64 = create_laplace_2d(48, 48)
    A32 = build_dist_matrix(a32, n_devices=1, local_format="dia",
                            dtype=np.float32)
    A64 = build_dist_matrix(a64, n_devices=1, local_format="dia",
                            dtype=np.float64)
    chip_smoke.phase_solves(a32, A32, a64, A64, dict(
        aggregate="interval2d", interval_size=4, cycle=2,
        local_format="dia", coarse_max=256))
    out = capsys.readouterr().out
    assert "cg_refined_dist(amg)" in out


def test_chip_smoke_four_card_phase_on_cpu_mesh(capsys):
    chip_smoke.phase_four_cards(128)
    out = capsys.readouterr().out
    assert "schedule-vanilla" in out and "interior_reads_halo=False" in out


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke at a reduced grid, where a GPU is present."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")
    assert chip_smoke.main(["--nx", "512", "--fem-nodes", "20000"]) == 0
