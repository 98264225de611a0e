"""JAX's persistent compilation cache, placed from outside or in the checkout.

Drivers (``bench.py``, ``chip_smoke.py``, ``benchmarks/``) call
:func:`enable_compile_cache` before their first compile.  When
``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and nothing is
changed; otherwise the cache goes to the fixed ``<checkout>/.jax_cache``
(listed in ``.gitignore``).  The path is part of what makes a later process
find the entries again, so it never depends on a temporary name, a PID or
the time.
"""
from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`."""
    import jax

    d = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", d)
    return d
