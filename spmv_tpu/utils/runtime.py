"""Process set-up for the programs that drive the library (chip_smoke.py,
bench.py, the demos' ``main``, ``__graft_entry__``'s ``__main__``).
Importing the library never calls it."""
from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def checkout_root() -> str:
    """The directory that holds the ``spmv_tpu`` package."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def setup_compile_cache(root: str | None = None) -> str:
    """Use JAX's persistent compilation cache. Where ``JAX_COMPILATION_CACHE_DIR``
    is set, JAX reads it itself and nothing is set here; otherwise the
    cache lives in ``<root>/.jax_cache`` (default root: the checkout).
    Returns the directory in use."""
    import jax

    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = os.path.join(root or checkout_root(), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
