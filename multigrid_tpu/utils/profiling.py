"""Tracing / profiling hooks.

The reference has no profiling machinery at all (SURVEY.md §5); here the
benchmark and training loops get named trace scopes (visible in TensorBoard/
Perfetto via ``jax.profiler``) and a small wall-clock phase timer that waits
for device completion, so numbers include the device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


def trace_annotation(name: str):
    """Named profiler scope (shows up in captured traces)."""
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Capture a device trace for the enclosed block."""
    with jax.profiler.trace(log_dir):
        yield


def force_completion(tree):
    """Block until every leaf of a pytree is computed; returns the tree."""
    return jax.block_until_ready(tree)


class PhaseTimer:
    """Accumulating wall-clock timer for named phases.

    >>> timer = PhaseTimer()
    >>> with timer.phase('rollout'):
    ...     out = rollout(...)
    ...     timer.sync(out)
    >>> timer.summary()  # {'rollout': {'total_s': ..., 'calls': ...}}
    """

    def __init__(self):
        self._total = defaultdict(float)
        self._calls = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._calls[name] += 1

    def sync(self, tree) -> None:
        force_completion(tree)

    def summary(self) -> dict:
        return {
            name: {'total_s': round(self._total[name], 4),
                   'calls': self._calls[name]}
            for name in self._total
        }
