"""flexpart_tpu_torch — the PyTorch/CUDA port of ``flexpart_tpu``.

The JAX package (``flexpart_tpu``) stays the reference; this package
re-implements it in PyTorch for one NVIDIA H100, slice by slice.  The
stock forward step is

  met (``met.synthetic`` -> ``met.verttransform.process_eta`` ->
  ``met.calcpar.calcpar``) -> per-step quad tables
  (``core.interp.build_step_tables_quad``) -> fixed-step advance
  (``core.advance.advance_chunked``) -> concentration sampling
  (``grid.conccalc.make_conccalc``),

and ``run.simulation.Simulation`` drives it from a configuration
(``config``) through release (``core.release``), the cell-order sort
(``core.reorder``) and the writers (``io``): forward, on one device, with
the fixed step.

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
    ``flexpart_tpu``: the modules of it that need no jax (``config``,
    ``utils.dates``, ``io.writer``, ``io.netcdf4``, the constants) are
    copied.
"""

__version__ = "0.1.0"

_LAZY = {"Simulation": ".run.simulation", "SyntheticMet": ".met.synthetic",
         "make_grid": ".met.synthetic"}


def __getattr__(name):
    # Simulation and the met backends on first use: importing the package
    # alone stays cheap and free of cycles
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
