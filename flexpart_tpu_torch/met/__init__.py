"""Met layer of the port: grids, synthetic backends and preprocessing
(the submodules ``verttransform`` and ``calcpar``)."""

from .grid import MetGrid, hybrid_coefficients
from .synthetic import SyntheticMet, make_grid, uniform_wind_met

__all__ = ["MetGrid", "SyntheticMet", "hybrid_coefficients", "make_grid",
           "uniform_wind_met"]
