"""Potential vorticity on the eta levels (port of
``flexpart_tpu/met/calcpv.py``, calcpv.f90).

PV = dtheta/dp * (f + (dv/dx / cos(phi) - du/dy + u tan(phi))/R)
* (-1e6 g), with the horizontal wind shear evaluated ON THE ISENTROPE
through each point: the neighbour's wind profile is interpolated to the
local potential temperature before differencing (calcpv.f90:85-210).
dtheta/dp takes one-sided differences at the lowest and the highest level;
a polar-cap row is replaced by the zonal mean of the row next to it
(calcpv.f90:219-245).

Plain PyTorch: it runs once per met read, on the device of the fields.
The interpolation is ``jnp.interp``'s, binary search included
(``_interp_columns``), so that a profile whose theta is not monotonic
picks the same bracket as the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import GA, KAPPA, PI180, R_EARTH
from ..core.interp import true_div
from .grid import MetGrid


def _searchsorted_right(xp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per column c, the index where each x[:, c] would go in xp[:, c]
    (side "right"), by the binary search of ``jnp.searchsorted``'s default
    method: ceil(log2(n + 1)) halvings of [0, n), going left where
    x < xp[mid].  For a sorted column it is ``torch.searchsorted``; for an
    unsorted one it is the bracket JAX picks."""
    n = xp.shape[0]
    low = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    high = torch.full(x.shape, n, dtype=torch.int64, device=x.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        val = torch.gather(xp, 0, mid)
        # NaN sorts last in JAX's comparator: a number goes left of it
        go_left = (x < val) | (torch.isnan(val) & ~torch.isnan(x))
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high


def _interp_columns(x, xp, fp):
    """``jnp.interp(x[:, c], xp[:, c], fp[:, c])`` for every column c of
    (nz, C) tensors: linear inside, the end values outside."""
    n = xp.shape[0]
    i = torch.clamp(_searchsorted_right(xp, x), 1, n - 1)
    xp_i, xp_m = torch.gather(xp, 0, i), torch.gather(xp, 0, i - 1)
    fp_i, fp_m = torch.gather(fp, 0, i), torch.gather(fp, 0, i - 1)
    df = fp_i - fp_m
    dx = xp_i - xp_m
    delta = x - xp_m
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp_m,
                    fp_m + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    f = torch.where(x < xp[:1], fp[:1].expand_as(f), f)
    return torch.where(x > xp[-1:], fp[-1:].expand_as(f), f)


def calcpv(grid: MetGrid, eta) -> torch.Tensor:
    """PV [pvu] on the eta levels, (nlev, ny, nx) float32, on the device
    of ``eta``."""
    dev = eta.ps.device
    akz = torch.as_tensor(np.asarray(grid.akz, np.float32), device=dev)
    bkz = torch.as_tensor(np.asarray(grid.bkz, np.float32), device=dev)
    lats = torch.as_tensor(np.asarray(grid.lats, np.float32), device=dev)
    dx = float(np.float32(grid.dx))
    dy = float(np.float32(grid.dy))
    ps, tth, uuh, vvh = eta.ps, eta.tth, eta.uuh, eta.vvh
    nz, ny, nx = tth.shape
    xglobal = grid.xglobal

    ppml = akz[:, None, None] + bkz[:, None, None] * ps[None]
    theta = tth * torch.pow(torch.full_like(ppml, 1.0e5) / ppml, KAPPA)

    # dtheta/dp with one-sided ends (calcpv.f90:76-83)
    th_p = torch.cat([theta[1:], theta[-1:]], dim=0)
    th_m = torch.cat([theta[:1], theta[:-1]], dim=0)
    pp_p = torch.cat([ppml[1:], ppml[-1:]], dim=0)
    pp_m = torch.cat([ppml[:1], ppml[:-1]], dim=0)
    dp = pp_p - pp_m
    dthetadp = (th_p - th_m) / torch.where(torch.abs(dp) < 1e-3,
                                           torch.full_like(dp, 1e-3), dp)

    def on_isentrope(field, theta_nb):
        """The neighbour's profile interpolated to the local theta."""
        c = ny * nx
        out = _interp_columns(theta.reshape(nz, c), theta_nb.reshape(nz, c),
                              field.reshape(nz, c))
        return out.reshape(nz, ny, nx)

    def shift_x(a, s):
        if xglobal:
            # physical domain is columns 0..nx-2 (nx-1 duplicates 0)
            rolled = torch.roll(a[..., :nx - 1], -s, dims=-1)
            return torch.cat([rolled, rolled[..., :1]], dim=-1)
        if s > 0:
            return torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
        return torch.cat([a[..., :1], a[..., :-1]], dim=-1)

    def shift_y(a, s):
        if s > 0:
            return torch.cat([a[:, 1:, :], a[:, -1:, :]], dim=1)
        return torch.cat([a[:, :1, :], a[:, :-1, :]], dim=1)

    dxrad = float(np.float32(dx) * np.float32(PI180))
    dyrad = float(np.float32(dy) * np.float32(PI180))
    v_e = on_isentrope(shift_x(vvh, +1), shift_x(theta, +1))
    v_w = on_isentrope(shift_x(vvh, -1), shift_x(theta, -1))
    u_n = on_isentrope(shift_y(uuh, +1), shift_y(theta, +1))
    u_s = on_isentrope(shift_y(uuh, -1), shift_y(theta, -1))
    edge_y = (torch.arange(ny, device=dev) == 0) \
        | (torch.arange(ny, device=dev) == ny - 1)
    jumpy = torch.where(edge_y, 1.0, 2.0).to(torch.float32)[None, :, None]
    if xglobal:
        dvdx = true_div(true_div(v_e - v_w, 2.0), dxrad)
    else:
        edge_x = (torch.arange(nx, device=dev) == 0) \
            | (torch.arange(nx, device=dev) == nx - 1)
        jumpx = torch.where(edge_x, 1.0, 2.0).to(torch.float32)[None, None, :]
        dvdx = true_div((v_e - v_w) / jumpx, dxrad)
    dudy = true_div((u_n - u_s) / jumpy, dyrad)

    phi = lats * PI180
    f_cor = (1.4585e-4 * torch.sin(phi))[None, :, None]
    cosphi = torch.cos(phi)[None, :, None]
    tanphi = torch.tan(phi)[None, :, None]
    # keep the metric finite at the poles; those rows are replaced below
    cosphi = torch.where(torch.abs(cosphi) < 1e-6,
                         torch.full_like(cosphi, 1e-6), cosphi)
    tanphi = torch.clamp(tanphi, -1e6, 1e6)

    pv = dthetadp * (f_cor + true_div(dvdx / cosphi - dudy + uuh * tanphi,
                                      R_EARTH)) * (-1.0e6) * GA

    if grid.sglobal:
        pv[:, 0, :] = pv[:, 1, :].mean(dim=-1, keepdim=True)
    if grid.nglobal:
        pv[:, -1, :] = pv[:, -2, :].mean(dim=-1, keepdim=True)
    return pv
