"""Persistent compile caches shared by the CLI entry points and tools.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and both
caches — XLA's compiled executables and the exported programs of
:mod:`tpu_gnss.utils.progcache` — live under it.  Where it is not set,
both live under ``<checkout>/.jax_cache``, a fixed path inside the
checkout (the path is part of the cache key, so a moving directory would
never hit).  The reference pays its equivalent cost — FPGA bitstream
load, c/main.cpp:14-38 — once per power-up too.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_root() -> str:
    """Directory that holds both caches (see the module docstring)."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))


def enable_persistent_cache() -> None:
    """Enable jax's on-disk compilation cache (idempotent), plus the
    exported-program cache (utils.progcache) that removes the remaining
    per-process trace+load cost from the hot-path programs."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_root(), exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_root())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    from . import progcache
    progcache.enable()
