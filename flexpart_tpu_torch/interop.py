"""Carry state and configuration between the JAX package and the port.

The JAX side hands its pytrees over as numpy arrays (``np.asarray`` on
each leaf, done by the caller), so this module never imports jax.  Each
``*_from_numpy`` takes an object with the JAX field attributes (a JAX
NamedTuple whose leaves are numpy arrays, or a dict) and returns the
port's dataclass with tensors on ``device``; each ``*_to_numpy`` goes
back to a dict of numpy arrays.  Each ``*_from_jax`` rebuilds one of the
JAX package's configuration dataclasses as the port's, field by field,
and ``simulation_from_jax`` a whole ``Simulation``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .core.advance import StepConfig, StepParams
from .core.interp import ROWS_E_LANES, StepTablesQuad
from .core.state import FIELDS, Particles
from .grid.outgrid import Accumulators
from .met.fields import ZFields

_PARTICLE_DTYPES = {
    "itra": np.int32, "itramem": np.int32, "npoint": np.int32,
    "nclass": np.int32, "idt": np.int32, "itrasplit": np.int32,
    "cbt": np.int8, "active": np.bool_,
}


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on ``device``."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy; bfloat16 is widened to float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def particles_from_numpy(p, device) -> Particles:
    out = {}
    for f in FIELDS:
        a = np.asarray(_get(p, f))
        out[f] = to_tensor(a.astype(_PARTICLE_DTYPES.get(f, np.float32),
                                    copy=False), device)
    return Particles(**out)


def particles_to_numpy(p: Particles) -> dict[str, np.ndarray]:
    return {f: to_numpy(getattr(p, f)) for f in FIELDS}


def zfields_from_numpy(z, device) -> ZFields:
    return ZFields(
        f3d=to_tensor(np.asarray(_get(z, "f3d"), np.float32), device),
        f2d=to_tensor(np.asarray(_get(z, "f2d"), np.float32), device),
        clouds=to_tensor(np.asarray(_get(z, "clouds"), np.int8), device),
        vdep=to_tensor(np.asarray(_get(z, "vdep"), np.float32), device),
        height=to_tensor(np.asarray(_get(z, "height"), np.float32), device))


def zfields_to_numpy(z: ZFields) -> dict[str, np.ndarray]:
    return {f.name: to_numpy(getattr(z, f.name))
            for f in dataclasses.fields(z)}


# the port's StepParams fields that the JAX package names otherwise
_STEP_PARAM_NAMES = {"xlon0": "xlon0_pol"}


def step_params_from_numpy(prm) -> StepParams:
    names = [f.name for f in dataclasses.fields(StepParams)]
    return StepParams(**{
        k: float(np.asarray(_get(prm, _STEP_PARAM_NAMES.get(k, k)))
                 .reshape(-1)[0]) for k in names})


def step_config_from_jax(cfg) -> StepConfig:
    """The JAX StepConfig (a plain NamedTuple) -> the port's StepConfig."""
    names = [f.name for f in dataclasses.fields(StepConfig)]
    kw = {k: _get(cfg, k) for k in names}
    if not kw["nests"] and _get(cfg, "nest_nx"):
        kw["nests"] = ((_get(cfg, "nest_nx"), _get(cfg, "nest_ny")),)
    return StepConfig(**kw)


def accumulators_from_numpy(acc, device) -> Accumulators:
    return Accumulators(**{
        f.name: to_tensor(np.asarray(_get(acc, f.name), np.float32), device)
        for f in dataclasses.fields(Accumulators)})


def accumulators_to_numpy(acc: Accumulators) -> dict[str, np.ndarray]:
    return {f.name: to_numpy(getattr(acc, f.name))
            for f in dataclasses.fields(acc)}


def tables_from_numpy(t, device) -> StepTablesQuad:
    """The JAX tables; its ``rowsE`` pads the 24 end-time lanes to 64, the
    port's to ``ROWS_E_LANES``."""
    rows_e = np.asarray(_get(t, "rowsE"))[:, :ROWS_E_LANES]
    return StepTablesQuad(rows=to_tensor(_get(t, "rows"), device),
                          rowsE=to_tensor(rows_e, device))


def _by_fields(cls, obj, **override):
    """``cls`` built from the like-named fields of ``obj``."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    kw.update(override)
    return cls(**kw)


def command_from_jax(cmd) -> _config.Command:
    return _by_fields(_config.Command, cmd)


def outgrid_from_jax(og) -> _config.OutGrid:
    return _by_fields(_config.OutGrid, og,
                      outheights=tuple(float(h) for h in og.outheights))


def ageclasses_from_jax(ac) -> _config.AgeClasses:
    return _by_fields(_config.AgeClasses, ac)


def releases_from_jax(rel) -> _config.Releases:
    return _config.Releases(
        species=tuple(_by_fields(_config.Species, s) for s in rel.species),
        boxes=tuple(_by_fields(_config.ReleaseBox, b) for b in rel.boxes))


def metgrid_from_jax(grid):
    from .met.grid import MetGrid
    return _by_fields(MetGrid, grid)


def simulation_from_jax(sim, device, met_backend=None, outdir=None):
    """The port's ``Simulation`` with the configuration of a JAX one and
    its convective flux memory ``cbmf`` (the particles are the port's own
    release schedule, equal to the JAX one's).  The met backend is not
    carried over (its ``fetch`` returns JAX arrays): ``met_backend`` is the
    port's, by default ``SyntheticMet`` on the same grid.  ``outdir``
    defaults to the JAX run's."""
    from .met.synthetic import SyntheticMet
    from .run.simulation import Simulation
    grid = metgrid_from_jax(sim.grid)
    if met_backend is None:
        met_backend = SyntheticMet(grid)
    own = {"cmd", "releases", "grid", "met_backend", "outgrid", "ageclasses",
           "outdir", "device"}
    rest = {f.name: getattr(sim, f.name)
            for f in dataclasses.fields(Simulation)
            if f.name not in own and hasattr(sim, f.name)}
    out = Simulation(
        cmd=command_from_jax(sim.cmd),
        releases=releases_from_jax(sim.releases), grid=grid,
        met_backend=met_backend, outgrid=outgrid_from_jax(sim.outgrid),
        ageclasses=ageclasses_from_jax(sim.ageclasses),
        outdir=sim.outdir if outdir is None else outdir, device=device,
        **rest)
    if getattr(sim, "cbmf", None) is not None and out.cbmf is not None:
        out.cbmf = to_tensor(np.asarray(sim.cbmf, np.float32), out.device)
    return out
