"""Plume-centroid trajectories with 5-cluster k-means (iout=4/5).

Re-design of plumetraj.f90 + clustering.f90 + centerofmass.f90: per
release point per output step, compute the particle cloud's center of
mass (on the unit sphere to handle date-line wrap), the fractions in
PBL / troposphere / |PV|<2 pvu, rms distances, and a 5-cluster
spherical k-means — written as one vectorized fixed-iteration pass over
(N, K) distance matrices instead of the reference's per-particle loops.
Appends to `trajectories.txt` in the reference's column layout.

Port: the JAX package's module (numpy on the host), copied, the cluster
step's invariants computed once and its distances in blocks (the same
values).  The particles come as tensors of any device; ``plume_step``
takes ``order``, the slots in schedule order (the port keeps its
particles in met-cell order, and k-means seeds its clusters by particle
order), so that both packages cluster the same sequence of particles.
Particles on a CUDA device are clustered there by
``cluster_particles_torch`` (the same formulas in torch): numpy would take
minutes over the 10**7 particles of a release point.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..constants import R_EARTH

NCLUSTER = 5


def _sphere_dist(lat1, lon1, lat2, lon2, coslat1=None):
    """Great-circle distance [m]; inputs in radians (distance2 analog);
    ``coslat1``: np.cos(lat1), where the caller has it."""
    if coslat1 is None:
        coslat1 = np.cos(lat1)
    s = np.sin(0.5 * (lat1 - lat2)) ** 2 \
        + coslat1 * np.cos(lat2) * np.sin(0.5 * (lon1 - lon2)) ** 2
    return 2.0 * R_EARTH * np.arcsin(np.minimum(np.sqrt(s), 1.0))


# particles per block of the distance matrix (the cluster step's (N, K)
# arrays in cache-sized pieces)
_ROWS = 1 << 16


def _nearest(lat, lon, coslat, clat, clon):
    """Each particle's nearest cluster centre and its distance: the JAX
    package's (N, K) distance matrix and argmin, made in blocks of rows
    (the same values: every entry is computed alone)."""
    n = len(lat)
    ncl = np.empty(n, np.int64)
    dmin = np.empty(n)
    for a in range(0, n, _ROWS):
        b = min(a + _ROWS, n)
        d = _sphere_dist(lat[a:b, None], lon[a:b, None], clat[None, :],
                         clon[None, :], coslat[a:b, None])
        ncl[a:b] = np.argmin(d, axis=1)
        dmin[a:b] = d[np.arange(b - a), ncl[a:b]]
    return ncl, dmin


def cluster_particles(lon_deg, lat_deg, z, iterations: int = 20):
    """5-cluster spherical k-means (clustering.f90): returns
    (lon, lat, z, fraction, rms) per cluster + total rms [km].  The JAX
    package's arithmetic, with what the iterations share computed once."""
    n = len(lon_deg)
    lon = np.deg2rad(lon_deg)
    lat = np.deg2rad(lat_deg)
    k = NCLUSTER
    if n < k:
        return None
    sel = (np.arange(1, k + 1) * n) // k - 1
    clon, clat = lon[sel].copy(), lat[sel].copy()
    coslat = np.cos(lat)
    # positions on the unit sphere, for the spherical means
    x = np.cos(lat) * np.sin(lon)
    y = -np.cos(lat) * np.cos(lon)
    zc = np.sin(lat)
    for _ in range(iterations):
        ncl, _ = _nearest(lat, lon, coslat, clat, clon)
        # spherical mean per cluster (clustering.f90:108-125)
        for j in range(k):
            m = ncl == j
            if m.sum() == 0:
                continue
            xm, ym, zm = x[m].mean(), y[m].mean(), zc[m].mean()
            clon[j] = np.arctan2(xm, -ym)
            clat[j] = np.arctan2(zm, np.sqrt(xm * xm + ym * ym))
    ncl, dmin = _nearest(lat, lon, coslat, clat, clon)
    rms = float(np.sqrt(np.mean(dmin ** 2)))
    out = []
    for j in range(k):
        m = ncl == j
        nj = int(m.sum())
        zj = float(z[m].mean()) if nj else 0.0
        rj = float(np.sqrt(np.mean(dmin[m] ** 2))) if nj else 0.0
        out.append((np.rad2deg(clon[j]), np.rad2deg(clat[j]), zj,
                    100.0 * nj / n, rj))
    return out, rms


@dataclasses.dataclass
class PlumeTrajWriter:
    """trajectories.txt writer (openouttraj.f90 header + plumetraj.f90
    output lines)."""
    path: Path
    releases: object
    bdate: object

    def __post_init__(self):
        self.path = Path(self.path)
        with self.path.open("w") as f:
            f.write(f"{self.bdate:%Y%m%d %H%M%S} FLEXPART_TPU\n")
            f.write(f"{self.releases.numpoint}\n")
            for j, b in enumerate(self.releases.boxes):
                f.write(f"{int((b.start - self.bdate).total_seconds())} "
                        f"{int((b.end - self.bdate).total_seconds())} "
                        f"{b.lon1:9.4f} {b.lat1:9.4f} {b.lon2:9.4f} "
                        f"{b.lat2:9.4f} {b.z1:9.3f} {b.z2:9.3f} "
                        f"{b.parts:d}\n")
                f.write(f"R{j + 1}\n")

    def write_step(self, itime: int, point: int, stats: dict,
                   clusters, rms: float):
        cols = (f"{point + 1:5d} {itime:10d} "
                f"{stats['xcenter']:9.4f} {stats['ycenter']:9.4f} "
                f"{stats['zcenter']:8.1f} "
                f"{stats['topocenter']:8.1f} {stats['hmixcenter']:8.1f} "
                f"{stats['tropocenter']:8.1f} {stats['pvcenter']:8.2f} "
                f"{stats['rmsdist']:10.1f} {rms:10.1f} "
                f"{stats['zrmsdist']:8.1f} {stats['zrms']:8.1f} "
                f"{stats['hmixfract']:6.1f} {stats['pvfract']:6.1f} "
                f"{stats['tropofract']:6.1f}")
        for (clon, clat, cz, frac, crms) in clusters:
            cols += (f" {clon:9.4f} {clat:9.4f} {cz:8.1f} {frac:6.1f} "
                     f"{crms:9.1f}")
        with self.path.open("a") as f:
            f.write(cols + "\n")


def cluster_particles_torch(lon_deg, lat_deg, z, iterations: int = 20):
    """``cluster_particles`` in torch on the tensors' device: the same
    formulas, each cluster's sums in float64.
    The card's way through the 10**7 particles of one release point, which
    numpy takes minutes over; the values round as the device's own math
    does, so they are held to the numpy version within a tolerance, not
    bitwise."""
    n = lon_deg.shape[0]
    k = NCLUSTER
    if n < k:
        return None
    dev = lon_deg.device
    lon = torch.deg2rad(lon_deg)
    lat = torch.deg2rad(lat_deg)
    sel = torch.as_tensor((np.arange(1, k + 1) * n) // k - 1, device=dev)
    clon, clat = lon[sel].clone(), lat[sel].clone()
    coslat = torch.cos(lat)
    x = coslat * torch.sin(lon)
    y = -coslat * torch.cos(lon)
    zc = torch.sin(lat)

    def nearest():
        s = torch.sin(0.5 * (lat[:, None] - clat[None, :])) ** 2 \
            + coslat[:, None] * torch.cos(clat)[None, :] \
            * torch.sin(0.5 * (lon[:, None] - clon[None, :])) ** 2
        d = 2.0 * R_EARTH * torch.asin(torch.clamp(torch.sqrt(s), max=1.0))
        ncl = torch.argmin(d, dim=1)
        return ncl, d.gather(1, ncl[:, None])[:, 0]

    def cluster_sums(ncl, *values):
        # one masked float64 sum per (value, cluster): an index_add_ of
        # 10**7 values into five bins is a queue of atomics on five words
        members = [ncl == j for j in range(k)]
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        return torch.stack([torch.stack([torch.where(m, v.double(), zero)
                                         .sum() for m in members])
                            for v in values])

    for _ in range(iterations):
        ncl, _ = nearest()
        counts = torch.bincount(ncl, minlength=k).double()
        xm, ym, zm = cluster_sums(ncl, x, y, zc) / counts.clamp(min=1.0)
        has = counts > 0
        clon = torch.where(has, torch.atan2(xm, -ym).to(clon.dtype), clon)
        clat = torch.where(has, torch.atan2(zm, torch.sqrt(xm * xm + ym * ym))
                           .to(clat.dtype), clat)
    ncl, dmin = nearest()
    counts = torch.bincount(ncl, minlength=k)
    zs, d2 = cluster_sums(ncl, z, dmin.double() ** 2)
    rms = float(torch.sqrt((dmin.double() ** 2).mean()))
    out = []
    for j in range(k):
        nj = int(counts[j])
        zj = float(zs[j] / nj) if nj else 0.0
        rj = float(torch.sqrt(d2[j] / nj)) if nj else 0.0
        out.append((float(torch.rad2deg(clon[j])),
                    float(torch.rad2deg(clat[j])), zj, 100.0 * nj / n, rj))
    return out, rms


def _host(a, order) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
    return a if order is None else a[order]


def plume_step(p, grid, diag, itime: int, numpoint: int,
               writer: PlumeTrajWriter, order=None):
    """One output step for all release points (plumetraj.f90:60-233).
    diag: particle_diagnostics output (topo, pv, qv, rho, hmix, tropo,
    tt); ``order``: the slots in schedule order (None: as they are).  The
    statistics are numpy on the host; the clusters too, but for particles
    on a CUDA device, which are clustered there
    (``cluster_particles_torch``)."""
    dev = p.x.device if isinstance(p.x, torch.Tensor) else None
    if isinstance(order, torch.Tensor):
        order = order.cpu().numpy()
    topo, pv, _, _, hmix, tropo, _ = (_host(a, order) for a in diag)
    live = _host(p.active, order) & (_host(p.itra, order) == itime)
    npoint = _host(p.npoint, order)
    x = _host(p.x, order)
    y = _host(p.y, order)
    z = _host(p.z, order)
    lon = grid.xlon0 + x * grid.dx
    lat = grid.ylat0 + y * grid.dy
    for j in range(numpoint):
        m = live & (npoint == j)
        n = int(m.sum())
        if n == 0:
            continue
        zl = z[m] + topo[m]                     # height ASL
        pvj = pv[m]
        latm = lat[m]
        pvfract = np.where(latm > 0, pvj < 2.0, pvj > -2.0).mean() * 100
        tropofract = (z[m] < tropo[m]).mean() * 100
        hmixfract = (z[m] < hmix[m]).mean() * 100
        # center of mass with cyclic longitude handling
        lam = np.deg2rad(lon[m])
        phi = np.deg2rad(latm)
        xc = np.cos(phi) * np.sin(lam)
        yc = -np.cos(phi) * np.cos(lam)
        zc = np.sin(phi)
        xcen = np.rad2deg(np.arctan2(xc.mean(), -yc.mean()))
        ycen = np.rad2deg(np.arctan2(
            zc.mean(), np.sqrt(xc.mean() ** 2 + yc.mean() ** 2)))
        dcen = _sphere_dist(phi, lam, np.deg2rad(ycen), np.deg2rad(xcen))
        stats = dict(
            xcenter=xcen, ycenter=ycen, zcenter=float(zl.mean()),
            topocenter=float(topo[m].mean()),
            hmixcenter=float(hmix[m].mean()),
            tropocenter=float((tropo[m] + topo[m]).mean()),
            pvcenter=float(pvj.mean()),
            rmsdist=float(np.sqrt(np.mean(dcen ** 2))),
            zrmsdist=float(np.sqrt(np.mean((zl - zl.mean()) ** 2))),
            zrms=float(np.sqrt(np.mean((zl - zl.mean()) ** 2))),
            hmixfract=hmixfract, pvfract=pvfract, tropofract=tropofract)
        if dev is not None and dev.type == "cuda":
            res = cluster_particles_torch(
                *(torch.as_tensor(a, device=dev) for a in (lon[m], latm, zl)))
        else:
            res = cluster_particles(lon[m], latm, zl)
        if res is None:
            clusters = [(xcen, ycen, float(zl.mean()), 100.0, 0.0)] \
                + [(0.0, 0.0, 0.0, 0.0, 0.0)] * (NCLUSTER - 1)
            rms = 0.0
        else:
            clusters, rms = res
        writer.write_step(itime, j, stats, clusters, rms)
