"""torch's vector math on the CPU: each MKL function's first call on one
thread.

torch's CPU build hands ``exp``, ``log``, ``sin``, ``cos``, ``tan``,
``atan``, ``sqrt`` and a few more elementwise functions of contiguous
float tensors to Intel MKL's vector math (VML), in chunks of 2048 elements
spread over its intra-op threads.  A VML function picks its code path at
its first call in a process; when several threads make that first call at
once, one of them can compute its chunk on a path of lower accuracy
(values off by up to about 1e-5, relatively) while later calls are right
again.  A plain version of the port that meets such a first call on more
than 2048 elements can then differ from itself, and from the JAX package,
in the particles of one chunk.  ``warm_vector_math`` makes the first call
of each of those functions on one thread; ``scripts/torch_vml_first_call.py``
shows the race and that the warm-up removes it.
"""

from __future__ import annotations

import torch

# the unary functions ATen hands to MKL VML for float tensors on the CPU
VML_FUNCTIONS = ("exp", "expm1", "log", "log10", "log1p", "sin", "cos",
                 "tan", "asin", "acos", "atan", "sqrt", "tanh", "erf",
                 "erfc", "erfinv", "lgamma")


def warm_vector_math() -> None:
    """Call each VML function once on one intra-op thread, in float32 and
    float64; torch's thread count is restored afterwards.  Cheap (a few
    hundred microseconds) and harmless to repeat."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name in VML_FUNCTIONS:
            fn = getattr(torch, name)
            for dtype in (torch.float32, torch.float64):
                fn(torch.full((16,), 0.5, dtype=dtype))
    finally:
        torch.set_num_threads(threads)
