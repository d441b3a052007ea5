"""Test configuration.

Tests run on the CPU with 8 virtual devices so multi-device sharding paths
can be exercised on a single host. The GPU path is checked by
``chip_smoke.py`` at the repository root.
"""

import os

flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8'
    ).strip()

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

from multigrid_tpu.utils.compile_cache import (  # noqa: E402
    cpu_fingerprint, enable_compilation_cache)

# Persistent compilation cache: amortizes jit compiles across test runs.
# XLA:CPU artifacts are specific to the host's instruction set, and loading
# one written on a different machine can SIGILL mid-run, so the default
# directory is keyed by a host-CPU fingerprint.
enable_compilation_cache(cpu_fingerprint())
