"""Where the persistent XLA compile cache lives.

One rule for every entry point (bench.py, the CLI, chip_smoke.py): if
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it; otherwise the cache goes to ``<checkout>/.jax_cache``
(listed in .gitignore). The default path is fixed, never derived from a
temporary name, a process id or the clock: the path is part of what a
later process looks up, so a moving directory never hits.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"

#: <checkout>/.jax_cache — the directory holding the package's parent
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; return it."""
    env = os.environ.get(ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    return CHECKOUT_CACHE_DIR
