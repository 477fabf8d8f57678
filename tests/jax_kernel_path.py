"""Run the JAX package's kernel path on the CPU, for the port's parity tests.

The JAX mappers take their accelerator path with ``extension="pallas"``:
local-mode candidates through ``banded_score_semiglobal_pallas`` (K3),
mate rescue through ``myers_semiglobal_pallas`` (K4) and K3, tracebacks
through ``batch_traceback_banded_fast`` (K2) and, for
``pe_full_traceback``, ``batch_traceback_full`` (K2 at band T+M; it passes
its own ``interpret`` on to K2, so it is rebound too). On the CPU those
Pallas kernels run only in interpret mode, so ``kernel_path()`` rebinds the
entry points to ``interpret=True`` for the duration of a ``with`` block.
The JAX callers import them at trace time, so the rebinding reaches them;
nothing in ``nvbio_tpu`` changes. Batches must not be a multiple of 1024
(that sends SEMI_GLOBAL candidates to the register-tiled K1 instead).
"""

from __future__ import annotations

import contextlib
import functools

import pytest

from nvbio_tpu.align import pallas_kernels as jpk
from nvbio_tpu.align import traceback as jtb

_ENTRY_POINTS = (
    (jpk, "myers_semiglobal_pallas"),
    (jpk, "banded_score_semiglobal_pallas"),
    (jtb, "batch_traceback_banded_fast"),
    (jtb, "batch_traceback_full"),
)


@contextlib.contextmanager
def kernel_path():
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in _ENTRY_POINTS:
            mp.setattr(mod, name,
                       functools.partial(getattr(mod, name), interpret=True))
        yield
