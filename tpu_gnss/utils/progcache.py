"""Disk-backed exported-program cache: skip per-process trace+load.

XLA's persistent compile cache removes the COMPILE from a fresh
process's first call, but the call still pays Python tracing + cache
lookup + executable load.  A ``jax.export`` blob saved alongside skips
the tracing entirely: a fresh process deserializes the StableHLO module
and jits its ``call``.  This is the software analog of the reference
keeping its compiled FPGA bitstream on flash instead of re-synthesizing
at boot (c/main.cpp:14-38 loads it per power-up).

Usage::

    from tpu_gnss.utils import progcache
    out = progcache.call("acq_refined", acquire_refined,
                         args=(samples, code_ffts, dops),
                         dyn_kwargs={},
                         static_kwargs=dict(fs=fs, n_coherent=4, ...))

Semantics:

- Disabled by default (plain call-through): tests and library users see
  stock jit behavior.  ``enable()`` — called by
  ``utils.jaxcache.enable_persistent_cache()`` so every CLI/bench entry
  point gets it — turns it on.
- Keys include a digest of the package's own source files: ANY code
  edit invalidates every cached program (stale math can never load).
- On a miss the original jit function runs (unchanged behavior) and the
  export is written by a background thread for the next process.
- ``dyn_kwargs`` stay traced arguments (one program serves any value);
  ``static_kwargs`` are baked into the exported program and keyed.
- Any export/deserialize failure falls back to the original function,
  permanently for that (process, key).
"""

from __future__ import annotations

import functools
import hashlib
import os
import threading
from typing import Any, Optional

_DIR: Optional[str] = None          # None = disabled
_memo: dict = {}                    # key -> jitted exp.call | False
_memo_lock = threading.Lock()
_SRC_DIGEST: Optional[str] = None
_export_threads: list = []          # live background export threads


def wait_exports(timeout: Optional[float] = None) -> None:
    """Block until outstanding background exports land (per thread
    ``timeout``).  Used by warmup flows that exist to SEED the cache —
    exiting before the daemon threads finish would discard the work."""
    for t in list(_export_threads):
        t.join(timeout)
    _export_threads[:] = [t for t in _export_threads if t.is_alive()]


def enable(path: Optional[str] = None) -> None:
    """Enable the cache, storing blobs under ``path`` (default:
    ``exported/`` under :func:`tpu_gnss.utils.jaxcache.cache_root`).

    ``TPU_GNSS_PROGCACHE=0`` in the environment vetoes (kill switch for
    debugging / misbehaving backends)."""
    global _DIR
    if os.environ.get("TPU_GNSS_PROGCACHE", "1") == "0":
        return
    from .jaxcache import cache_root
    d = path or os.path.join(cache_root(), "exported")
    os.makedirs(d, exist_ok=True)
    _DIR = d


def disable() -> None:
    global _DIR
    _DIR = None


def enabled() -> bool:
    return _DIR is not None


def _source_digest() -> str:
    """Digest over the package's .py sources (computed once)."""
    global _SRC_DIGEST
    if _SRC_DIGEST is None:
        import tpu_gnss
        root = os.path.dirname(os.path.abspath(tpu_gnss.__file__))
        h = hashlib.sha256()
        for dirpath, _dirs, files in sorted(os.walk(root)):
            for f in sorted(files):
                if f.endswith(".py"):
                    p = os.path.join(dirpath, f)
                    h.update(p.encode())
                    with open(p, "rb") as fh:
                        h.update(fh.read())
        _SRC_DIGEST = h.hexdigest()[:16]
    return _SRC_DIGEST


def _leaf_sig(x: Any) -> str:
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return f"{x.dtype}{tuple(x.shape)}"
    return f"py:{type(x).__name__}"    # python scalars stay traced


def _key(name: str, args, dyn_kwargs, static_kwargs) -> str:
    import jax
    leaves, treedef = jax.tree.flatten((args, dyn_kwargs))
    parts = [name, jax.__version__, jax.devices()[0].platform,
             _source_digest(), str(treedef),
             ",".join(_leaf_sig(x) for x in leaves),
             repr(sorted(static_kwargs.items()))]
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:24]


def _export_async(key: str, fn, args, dyn_kwargs, static_kwargs) -> None:
    """Serialize the program for the NEXT process (best-effort)."""
    path = os.path.join(_DIR, key + ".jaxexp")

    def work():
        tmp = path + f".tmp{os.getpid()}"
        try:
            import jax
            bound = jax.jit(functools.partial(fn, **static_kwargs))
            blob = jax.export.export(bound)(*args, **dyn_kwargs).serialize()
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except Exception:
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except Exception:
                pass

    t = threading.Thread(target=work, daemon=True)
    _export_threads.append(t)
    t.start()


def call(name: str, fn, args: tuple = (), dyn_kwargs: Optional[dict] = None,
         static_kwargs: Optional[dict] = None) -> Any:
    """Call ``fn(*args, **dyn_kwargs, **static_kwargs)`` through the cache.

    ``fn`` must be a jit-wrapped pure function.  When disabled, this is
    exactly that call.  When enabled, a previously exported program for
    the same (source version, shapes, statics) executes instead —
    identical math, no tracing.
    """
    dyn_kwargs = dyn_kwargs or {}
    static_kwargs = static_kwargs or {}
    if _DIR is None:
        return fn(*args, **dyn_kwargs, **static_kwargs)
    key = _key(name, args, dyn_kwargs, static_kwargs)
    with _memo_lock:
        ent = _memo.get(key)
    if ent is None:
        import jax
        path = os.path.join(_DIR, key + ".jaxexp")
        ent = False
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    exp = jax.export.deserialize(f.read())
                ent = jax.jit(exp.call)
            except Exception:
                ent = False
        with _memo_lock:
            _memo[key] = ent
        if ent is False:
            _export_async(key, fn, args, dyn_kwargs, static_kwargs)
    if ent is False:
        return fn(*args, **dyn_kwargs, **static_kwargs)
    return ent(*args, **dyn_kwargs)
