"""What the kernel A/B scripts (``torch_k8_ab.py``, ``torch_k11_ab.py``)
share: a kernel of ``flexpart_tpu_torch._build`` built from another source
file with the same entry and arguments, swapped in for the checkout's
while its wrapper launches it, and timed in turns beside the checkout's
on one CUDA card."""

from __future__ import annotations

import contextlib
from pathlib import Path

import chip_smoke as cs


def source_kernel(kernel, src: Path, argtypes=None):
    """``kernel`` built from ``src`` in place of its ``csrc/`` file, in the
    same parts: an older commit's source (``git show <commit>:<path> >
    build/<dir>/..``) or an edited copy of this one (another
    compile-time constant, another design).  Headers beside ``src`` are
    found before those of ``csrc/`` (quoted includes).  ``argtypes``: the older source's, where
    its exported function took other arguments."""
    from flexpart_tpu_torch import _build

    class SourceKernel(_build.Kernel):
        @property
        def source(self) -> Path:
            return src

    return SourceKernel(kernel.name, kernel.symbol,
                        kernel.argtypes if argtypes is None else argtypes,
                        kernel.parts, kernel.defines)


def kernel_for(kernel, arg: str, root: Path):
    """(name, kernel) of a command-line argument: the path of a ``.cu``
    file (an older commit's source, or an edited copy of this one under
    ``build/``)."""
    src = Path(arg).resolve()
    name = str(src.relative_to(root)) if src.is_relative_to(root) else arg
    return name, source_kernel(kernel, src)


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


def in_turns(launch, this: str, others: list, reps: int,
             timer=None) -> dict:
    """CUDA-event milliseconds of ``launch(name)``, ``reps`` launches after
    a warm-up (``timer``: chip_smoke.cuda_ms unless given, e.g.
    chip_smoke.cuda_graph_ms for launches shorter than the host's), in
    turns: the others in the order given, this checkout twice, the others
    in reverse; {name: [ms, ...]}."""
    timer = cs.cuda_ms if timer is None else timer
    out = {n: [] for n in [this, *others]}
    for name in [*others, this, this, *others[::-1]]:
        out[name].append(timer(lambda: launch(name), reps))
    return out
