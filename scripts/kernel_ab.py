"""What the kernel A/B scripts (``torch_k8_ab.py``, ``torch_k11_ab.py``)
share: a kernel of ``flexpart_tpu_torch._build`` built from another source
file with the same entry and arguments, swapped in for the checkout's
while its wrapper launches it, and timed in turns beside the checkout's
on one CUDA card."""

from __future__ import annotations

import contextlib
from pathlib import Path

import chip_smoke as cs


def source_kernel(kernel, src: Path):
    """``kernel`` built from ``src`` in place of its ``csrc/`` file: an
    older commit's source (``git show <commit>:<path> > build/<dir>/..``)
    or this one with another compile-time constant.  Headers beside
    ``src`` are found before those of ``csrc/`` (quoted includes)."""
    from flexpart_tpu_torch import _build

    class SourceKernel(_build.Kernel):
        @property
        def source(self) -> Path:
            return src

    return SourceKernel(kernel.name, kernel.symbol, kernel.argtypes)


@contextlib.contextmanager
def swapped(attr: str, kernel):
    """``_build.<attr>`` is ``kernel`` inside the block."""
    from flexpart_tpu_torch import _build
    saved = getattr(_build, attr)
    setattr(_build, attr, kernel)
    try:
        yield
    finally:
        setattr(_build, attr, saved)


def in_turns(launch, this: str, others: list, reps: int) -> dict:
    """CUDA-event milliseconds of ``launch(name)``, ``reps`` launches after
    a warm-up (chip_smoke.cuda_ms), in turns: the others in the order
    given, this checkout twice, the others in reverse; {name: [ms, ...]}."""
    out = {n: [] for n in [this, *others]}
    for name in [*others, this, this, *others[::-1]]:
        out[name].append(cs.cuda_ms(lambda: launch(name), reps))
    return out
