"""Met layer of the port: grids, synthetic backends and preprocessing
(verttransform, calcpar)."""
