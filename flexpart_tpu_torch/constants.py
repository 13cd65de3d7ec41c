"""Physical constants and model parameters of the stock step.

The values of ``flexpart_tpu/constants.py`` (par_mod.f90:59-135), copied
so that the port runs without the JAX package installed; the parity tests
check that the two sets agree.
"""

from __future__ import annotations

import math

PI = math.pi
R_EARTH = 6.371e6        # radius of earth [m]
R_AIR = 287.05           # gas constant, dry air [J/kg/K]
GA = 9.81                # gravitational acceleration [m/s^2]
CPA = 1004.6             # specific heat of dry air [J/kg/K]
PI180 = PI / 180.0
KARMAN = 0.40
KAPPA = 0.286            # poisson exponent for potential temperature

CONVKE = 2.0             # share of kinetic energy usable for lifting
HMIXMIN = 100.0          # minimum PBL height [m]
HMIXMAX = 4500.0         # maximum PBL height [m]
D_TROP = 50.0            # horizontal diffusivity, free troposphere [m2/s]
D_STRAT = 0.1            # vertical diffusivity, stratosphere [m2/s]
TURBMESOSCALE = 0.16     # mesoscale wind fluctuation factor
HREF = 15.0              # reference height for dry deposition [m]
INCLOUD_RATIO = 6.2      # in-cloud scavenging ratio (par_mod.f90:95)
NUMCLASS = 13            # number of landuse classes
NI = 11                  # number of particle diameter classes
