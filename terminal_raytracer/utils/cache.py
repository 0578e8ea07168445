"""Where compiled programs persist between runs.

JAX keeps its persistent compilation cache where `JAX_COMPILATION_CACHE_DIR`
says, when that is set, and this module then sets nothing. Otherwise the
cache lives at a fixed path inside the checkout, `<checkout>/.jax_cache`
(listed in .gitignore): the path is part of the cache key, so a directory
that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> Optional[Path]:
    """Turn the persistent cache on; returns the directory this call set,
    or None when JAX's own setting governs (or the default is not
    writable)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    import jax

    try:
        CHECKOUT_CACHE.mkdir(exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return CHECKOUT_CACHE
