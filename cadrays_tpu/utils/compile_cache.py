"""Where the persistent XLA compilation cache lives.

`JAX_COMPILATION_CACHE_DIR`, when set, is used as it is (JAX reads it
itself) and nothing is set in code. Otherwise the cache goes to one fixed
directory inside the checkout, `<repo>/.jax_cache`: the directory is part
of the cache key, so a path that changed from run to run would never hit.
The entry points (`cli.render`, `cli.console`, `cli.viewer`, `bench.py`,
`chip_smoke.py`) call `configure_compile_cache` once at start-up.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir(environ=None) -> str:
    """The cache directory the rule above picks for `environ`."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at `cache_dir()`; returns the path."""
    import jax

    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
