"""Artifact cache: rectification maps, tree plans, compiled executables.

The reference's only persistence is ad-hoc ``imwrite``/YAML artifacts
(SURVEY §5 checkpoint/resume). This engine's analog caches expensive
host-side precomputations keyed by a content hash:

* rectification maps keyed by (calibration bytes, image size),
* segment-tree structures / filter plans keyed by (image bytes, build
  params) — useful when re-processing identical frames or calibrated rigs,
* XLA compilation caching is delegated to JAX's persistent cache
  (``jax_compilation_cache_dir``), which :func:`enable_jit_cache` turns on.
"""

from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Callable, Optional

import numpy as np


def content_key(*parts: Any) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
            h.update(str(p.shape).encode())
            h.update(str(p.dtype).encode())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()[:32]


class ArtifactCache:
    """Tiny content-addressed pickle cache with an in-memory tier."""

    def __init__(self, directory: Optional[str] = None) -> None:
        self.directory = directory or os.path.join(
            os.path.expanduser("~"), ".cache", "gpu_stereo_matching_tpu"
        )
        self._mem: dict = {}

    def get_or_compute(self, key: str, compute: Callable[[], Any]) -> Any:
        if key in self._mem:
            return self._mem[key]
        path = os.path.join(self.directory, key + ".pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                value = pickle.load(f)
            self._mem[key] = value
            return value
        value = compute()
        os.makedirs(self.directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
        self._mem[key] = value
        return value


_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def jit_cache_dir() -> str:
    """Where compiled executables are kept: ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else ``.jax_cache`` at the root of the checkout (a
    fixed path, since the path is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_jit_cache() -> None:
    """Turn on JAX's persistent compilation cache (compile-once semantics
    across processes — the 'checkpoint' for XLA executables).

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; only when it is unset
    is the in-checkout directory configured here.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", jit_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

