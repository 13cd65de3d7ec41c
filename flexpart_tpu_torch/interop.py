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
from .core.advance import (NEST_PARAMS, SPECIES_PARAMS, StepConfig,
                           StepParams)
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


def rank_rows_from_numpy(p, world: int, rank: int) -> dict[str, np.ndarray]:
    """A data-parallel rank's rows of a global particle state (a JAX
    ``Particles`` with numpy leaves, or a dict), as numpy by field: the
    capacity padded with empty slots to a multiple of ``world``, then the
    contiguous rows ``[rank * L, (rank + 1) * L)`` (the JAX package's
    ``P("p")`` sharding; parallel/sharding.py)."""
    from .parallel.sharding import pad_particles
    rows = pad_particles({f: np.asarray(_get(p, f)).astype(
        _PARTICLE_DTYPES.get(f, np.float32), copy=False) for f in FIELDS},
        world)
    per = len(rows["z"]) // world
    return {f: a[rank * per:(rank + 1) * per] for f, a in rows.items()}


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
    """The JAX StepParams (numpy leaves) -> the port's: a scalar field as a
    float, each species' settling parameter and each nest's window as a
    tuple of floats, one per species or nest."""
    out = {}
    for f in dataclasses.fields(StepParams):
        a = np.asarray(_get(prm, _STEP_PARAM_NAMES.get(f.name, f.name)),
                       np.float32).reshape(-1)
        out[f.name] = (tuple(float(v) for v in a)
                       if f.name in SPECIES_PARAMS + NEST_PARAMS
                       else float(a[0]))
    return StepParams(**out)


# the JAX StepConfig's fields that the port maps onto one of its own: the
# single nest's shape (superseded by ``nests`` when that is set)
_STEP_CONFIG_MAPPED = ("nest_nx", "nest_ny")
# and those it knows and ignores: ``maxsubsteps`` is unused in the JAX
# package, and the port takes the species from the mass array's shape
_STEP_CONFIG_IGNORED = ("maxsubsteps", "nspec")


def step_config_from_jax(cfg) -> StepConfig:
    """The JAX StepConfig (a plain NamedTuple, or a dict) -> the port's
    StepConfig.  Every JAX field is carried, mapped or on the list of those
    known and ignored; any other raises ValueError by name, so that a
    converted config never computes something its JAX twin does not."""
    names = [f.name for f in dataclasses.fields(StepConfig)]
    given = list(cfg) if isinstance(cfg, dict) else list(cfg._fields)
    unknown = [k for k in given if k not in names
               and k not in _STEP_CONFIG_MAPPED + _STEP_CONFIG_IGNORED]
    if unknown:
        raise ValueError(f"StepConfig fields the port neither carries nor "
                         f"maps: {', '.join(unknown)}")
    kw = {k: _get(cfg, k) for k in names if k in given}
    if not kw.get("nests") and "nest_nx" in given and _get(cfg, "nest_nx"):
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


def drydep_tables_from_jax(td):
    """The JAX package's ``DrydepTables`` (numpy already) as the port's."""
    from .physics.drydepo import DrydepTables
    return DrydepTables(**{f.name: np.array(getattr(td, f.name), copy=True)
                           for f in dataclasses.fields(DrydepTables)})


def oh_field_from_jax(field):
    """The JAX package's ``OHField`` (numpy arrays) as the port's."""
    from .physics.ohchem import OHField
    return OHField(**{f.name: np.array(getattr(field, f.name), copy=True)
                      for f in dataclasses.fields(OHField)})


def receptors_from_jax(receptors) -> tuple:
    return tuple(_by_fields(_config.Receptor, r) for r in receptors)


def boundary_from_jax(bs, device):
    """The JAX package's ``BoundaryState`` (numpy leaves, or a dict of
    them) as the port's."""
    from .core.domainfill import BoundaryState
    return BoundaryState.from_numpy(bs, device)


def simulation_from_jax(sim, device, met_backend=None, outdir=None):
    """The port's ``Simulation`` with the configuration of a JAX one (the
    deposition fields ``options_dir`` and ``minmass``, ``capacity``, the OH
    climatology, ``checkpoint_at`` and ``checkpoint_path``, the receptors
    and the nested output grid among the rest; the fluxes, the
    initial-condition sensitivity and the domain fill follow from the
    ``Command``) and its convective flux memory ``cbmf`` (the particles are
    the port's own release schedule, equal to the JAX one's).  A JAX
    domain fill that has been made (its run started) carries its particles,
    its air mass and its boundary state across.  The met backend is not
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
    if rest.get("oh_field") is not None:
        rest["oh_field"] = oh_field_from_jax(rest["oh_field"])
    if rest.get("receptors"):
        rest["receptors"] = receptors_from_jax(rest["receptors"])
    if rest.get("outgrid_nest") is not None:
        rest["outgrid_nest"] = outgrid_from_jax(rest["outgrid_nest"])
    out = Simulation(
        cmd=command_from_jax(sim.cmd),
        releases=releases_from_jax(sim.releases), grid=grid,
        met_backend=met_backend, outgrid=outgrid_from_jax(sim.outgrid),
        ageclasses=ageclasses_from_jax(sim.ageclasses),
        outdir=sim.outdir if outdir is None else outdir, device=device,
        **rest)
    if getattr(sim, "cbmf", None) is not None and out.cbmf is not None:
        out.cbmf = to_tensor(np.asarray(sim.cbmf, np.float32), out.device)
    if out.cmd.mdomainfill >= 1 and sim.particles is not None:
        out.particles = particles_from_numpy(
            {f: np.asarray(getattr(sim.particles, f)) for f in FIELDS},
            out.device)
        out.airmass_total = sim.airmass_total
        if getattr(sim, "_boundary", None) is not None:
            out._boundary = boundary_from_jax(
                {f: np.asarray(v) for f, v in sim._boundary._asdict()
                 .items()}, out.device)
    return out
