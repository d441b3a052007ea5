"""multigrid_tpu — an accelerator-native multi-agent gridworld RL framework.

A from-scratch JAX/XLA re-design of the capabilities of
``ini/multigrid``: the gridworld lives as dense integer arrays, the
multi-agent step is a pure jit-compiled transition function, observations are
vmapped gather kernels, and thousands of environments run in lockstep via
``vmap`` / shard across hosts via a device mesh.
"""

from .core import (
    Action,
    Color,
    Direction,
    EnvConfig,
    MultiGridState,
    State,
    Type,
)
from .envs import CONFIGURATIONS, make
from .envs.env import MultiGridEnv
from .parallel import VectorEnv

__version__ = '0.1.0'

__all__ = [
    'Action', 'CONFIGURATIONS', 'Color', 'Direction', 'EnvConfig',
    'MultiGridEnv', 'MultiGridState', 'State', 'Type', 'VectorEnv', 'make',
]
