"""Physics modules of the port (``flexpart_tpu/physics``): the Emanuel
convection scheme and the particle redistribution, wet and dry deposition,
decay.

Only ``setup_drydep`` is exported here: a name exported by this package
must not shadow one of its submodules (``wetdepo``, ``drydepo``, ...)."""


def setup_drydep(options_dir, grid, species, lsm, mmdd: int):
    """Load landuse + Wesely tables from an options/ dir (IGBP_int1.dat,
    surfdata.t, surfdepo.t — the reference's input data files) and build
    the static dry-deposition tables for this run
    (``flexpart_tpu/physics/__init__.py:10-25``)."""
    from pathlib import Path

    import numpy as np

    from .drydepo import build_drydep_tables
    from .landuse import (assign_landuse, read_landuse_inventory,
                          read_surfdata, read_surfdepo)
    d = Path(options_dir)
    inv = read_landuse_inventory(d / "IGBP_int1.dat")
    z0 = read_surfdata(d / "surfdata.t")
    tables = read_surfdepo(d / "surfdepo.t")
    xlanduse = assign_landuse(grid.nx, grid.ny, grid.dx, grid.dy,
                              grid.xlon0, grid.ylat0,
                              np.asarray(lsm), inv)
    return build_drydep_tables(species, xlanduse, z0, tables, mmdd,
                               grid.ylat0, grid.dy, grid.ny)
