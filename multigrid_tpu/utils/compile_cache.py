"""JAX's persistent compilation cache, kept in one place for every entry point.

The directory is part of each entry's key, so it must not move between runs:
``JAX_COMPILATION_CACHE_DIR`` when the environment sets it, otherwise the
fixed ``.jax_cache/`` directory at the root of the checkout.
"""

from __future__ import annotations

import os

import jax

#: Root of the checkout this package was imported from.
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir(subdir: str | None = None) -> str:
    """The compilation cache directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins as it is, with no ``subdir``.
    Otherwise ``<checkout>/.jax_cache[/<subdir>]``; ``subdir`` keeps apart
    artifacts that are only valid on one kind of host (XLA:CPU code is
    specific to the host's instruction set).
    """
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    root = os.path.join(_CHECKOUT, '.jax_cache')
    return os.path.join(root, subdir) if subdir else root


def enable_compilation_cache(subdir: str | None = None) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Call before the first compilation. Returns the directory used.
    """
    path = cache_dir(subdir)
    jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.2)
    return path


def cpu_fingerprint() -> str:
    """Short hash of this host's CPU feature flags (``/proc/cpuinfo``)."""
    import hashlib
    try:
        with open('/proc/cpuinfo') as f:
            flags = next(
                (line for line in f if line.startswith('flags')), '')
    except OSError:
        flags = ''
    return hashlib.sha1(flags.encode()).hexdigest()[:12]
