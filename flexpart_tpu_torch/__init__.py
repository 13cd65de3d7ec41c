"""flexpart_tpu_torch — the PyTorch/CUDA port of ``flexpart_tpu``.

The JAX package (``flexpart_tpu``) stays the reference; this package
re-implements it in PyTorch for one NVIDIA H100, slice by slice.  The
first slice is the stock forward step:

  met (``met.synthetic`` -> ``met.verttransform.process_eta`` ->
  ``met.calcpar.calcpar``) -> per-step quad tables
  (``core.interp.build_step_tables_quad``) -> fixed-step advance
  (``core.advance.advance_chunked``) -> concentration sampling
  (``grid.conccalc.make_conccalc``).

Design rules:
  * state is dataclasses of tensors with plain functions over them;
    nothing is learned, so nothing is an ``nn.Module``;
  * every function works on the device of the tensors it is given (or
    the ``device`` it is passed); there is no module-level device
    choice;
  * each hand-written CUDA kernel (``csrc/``) has a plain PyTorch twin in
    the same module.  A wrapper takes the twin only for CPU tensors; for a
    CUDA tensor it launches the kernel or raises;
  * the package imports ``torch`` and never ``jax``, nor anything of
    ``flexpart_tpu``: the few constants and the OUTGRID dataclass it needs
    are copied (``constants.py``, ``config.py``).
"""

__version__ = "0.1.0"
