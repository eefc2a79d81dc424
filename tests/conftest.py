"""Test harness configuration.

Multi-device testing strategy (SURVEY.md section 4 implication): where the
reference runs every test under ``mpiexec -np {1,2}``
(reference tests/CMakeLists.txt:22-30), we force N=8 virtual CPU devices via
XLA's host-platform flag, so distributed paths run on a real mesh with real
collectives without accelerator hardware. Must be set before jax imports.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "true")

import jax  # noqa: E402

# A pytest plugin may have imported jax before this conftest ran, in which
# case the env vars above were read too late — force via config (the backend
# is not initialized until first use, so this is still in time).
jax.config.update("jax_platforms", "cpu")
# fp64 paths: the reference is double-throughout (Matrix<double>); CPU tests
# verify both fp32 and fp64 to the demo tolerances.
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs
