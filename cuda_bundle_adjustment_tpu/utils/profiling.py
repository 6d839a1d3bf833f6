"""Stage timing: the reference's TimeProfile with the same 9 stage keys
(/root/reference/src/block_solver.cpp:470-488).

Timers call ``block_until_ready`` on a representative array before reading the
clock — the equivalent of the reference's CUDA-event stage brackets
(cuda_device.cpp:284-292).  ``TimeProfile`` is a plain dict keyed by the
human-readable stage names.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

PROF_INITIALIZE = "0: Initialize Optimizer"
PROF_BUILD_STRUCTURE = "1: Build Structure"
PROF_COMPUTE_ERROR = "2: Compute Error"
PROF_BUILD_SYSTEM = "3: Build System"
PROF_SCHUR_COMPLEMENT = "4: Schur Complement"
PROF_SYMBOLIC_DECOMP = "5: Symbolic Decomposition"
PROF_NUMERICAL_DECOMP = "6: Numerical Decomposition"
PROF_UPDATE = "7: Update Solution"
PROF_SOLVE_HPP = "8: Hpp linear solver"

ALL_STAGES = [
    PROF_INITIALIZE,
    PROF_BUILD_STRUCTURE,
    PROF_COMPUTE_ERROR,
    PROF_BUILD_SYSTEM,
    PROF_SCHUR_COMPLEMENT,
    PROF_SYMBOLIC_DECOMP,
    PROF_NUMERICAL_DECOMP,
    PROF_UPDATE,
    PROF_SOLVE_HPP,
]

TimeProfile = dict


class StageTimer:
    def __init__(self):
        self.profile: TimeProfile = {k: 0.0 for k in ALL_STAGES}

    def clear(self) -> None:
        for k in self.profile:
            self.profile[k] = 0.0

    @contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            import jax

            # NameError/UnboundLocalError only: a ``sync=lambda: x`` thunk
            # legitimately refers to a name the stage body never bound on
            # early-exit paths; anything else (device error, bad array)
            # must propagate, not be silently timed away
            try:
                val = sync() if callable(sync) else sync
            except (NameError, UnboundLocalError):
                val = None
            if val is not None:
                jax.block_until_ready(val)
        self.profile[name] = self.profile.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    def add(self, name: str, millis: float) -> None:
        self.profile[name] = self.profile.get(name, 0.0) + millis
