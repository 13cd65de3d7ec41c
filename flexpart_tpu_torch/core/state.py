"""Particle state: fixed-capacity SoA tensors.

Port of ``flexpart_tpu/core/state.py``.  Same fields and dtypes as the
JAX pytree (positions as double-single hi+lo float32 pairs, ``cbt``
int8, ``active`` bool, the time/index fields int32), held in a dataclass
of tensors that all live on one device.
"""

from __future__ import annotations

import dataclasses

import torch

# itra value for slots that are not scheduled (terminated/not yet released)
ITRA_INACTIVE = -999999999

FIELDS = ("x_hi", "x_lo", "y_hi", "y_lo", "z", "itra", "itramem", "npoint",
          "nclass", "idt", "itrasplit", "up", "vp", "wp", "usig", "vsig",
          "wsig", "cbt", "mass", "mass0", "xscav", "active")


@dataclasses.dataclass
class Particles:
    x_hi: torch.Tensor     # (N,) f32 grid units
    x_lo: torch.Tensor     # (N,) f32 low part
    y_hi: torch.Tensor
    y_lo: torch.Tensor
    z: torch.Tensor        # (N,) f32 metres above ground
    itra: torch.Tensor     # (N,) i32 time of next update [s]
    itramem: torch.Tensor  # (N,) i32 release time [s]
    npoint: torch.Tensor   # (N,) i32 release point index
    nclass: torch.Tensor   # (N,) i32 uncertainty class
    idt: torch.Tensor      # (N,) i32 adaptive time-step memory [s]
    itrasplit: torch.Tensor  # (N,) i32 next split time [s]
    up: torch.Tensor       # (N,) f32 turbulent velocities
    vp: torch.Tensor
    wp: torch.Tensor
    usig: torch.Tensor     # (N,) f32 mesoscale velocity memory
    vsig: torch.Tensor
    wsig: torch.Tensor
    cbt: torch.Tensor      # (N,) i8 forbidden-state flag (+1/-1)
    mass: torch.Tensor     # (N, nspec) f32
    mass0: torch.Tensor    # (N, nspec) f32
    xscav: torch.Tensor    # (N, nspec) f32
    active: torch.Tensor   # (N,) bool

    @property
    def capacity(self) -> int:
        return self.x_hi.shape[0]

    @property
    def nspec(self) -> int:
        return self.mass.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x_hi.device

    @property
    def x(self) -> torch.Tensor:
        return self.x_hi + self.x_lo

    @property
    def y(self) -> torch.Tensor:
        return self.y_hi + self.y_lo

    def replace(self, **kw) -> "Particles":
        return dataclasses.replace(self, **kw)

    def rows(self, a: int, b: int) -> "Particles":
        """Particles a..b-1 (views, no copy)."""
        return Particles(**{f: getattr(self, f)[a:b] for f in FIELDS})

    @staticmethod
    def cat(parts: list["Particles"]) -> "Particles":
        return Particles(**{f: torch.cat([getattr(q, f) for q in parts])
                            for f in FIELDS})


def empty_particles(capacity: int, nspec: int = 1, *,
                    device: torch.device | str) -> Particles:
    def zf():
        return torch.zeros(capacity, dtype=torch.float32, device=device)

    def zi():
        return torch.zeros(capacity, dtype=torch.int32, device=device)

    def inactive():
        return torch.full((capacity,), ITRA_INACTIVE, dtype=torch.int32,
                          device=device)

    def zm():
        return torch.zeros((capacity, nspec), dtype=torch.float32,
                           device=device)

    return Particles(
        x_hi=zf(), x_lo=zf(), y_hi=zf(), y_lo=zf(), z=zf(),
        itra=inactive(), itramem=zi(), npoint=zi(), nclass=zi(), idt=zi(),
        itrasplit=inactive(),
        up=zf(), vp=zf(), wp=zf(), usig=zf(), vsig=zf(), wsig=zf(),
        cbt=torch.ones(capacity, dtype=torch.int8, device=device),
        mass=zm(), mass0=zm(),
        xscav=torch.ones((capacity, nspec), dtype=torch.float32,
                         device=device),
        active=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def ds_add(hi: torch.Tensor, lo: torch.Tensor, d: torch.Tensor):
    """Double-single accumulate: (hi, lo) + d with error-free two-sum.

    Each line is one eager float32 op, so nothing is contracted into an
    FMA or reassociated (the two-sum needs every rounding)."""
    s = hi + d
    bb = s - hi
    err = (hi - (s - bb)) + (d - bb)
    lo2 = lo + err
    hi2 = s + lo2
    lo3 = lo2 - (hi2 - s)
    return hi2, lo3


def ds_value(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return hi + lo


def ds_set(val: torch.Tensor):
    """Build a (hi, lo) pair from a plain float32 value."""
    return val, torch.zeros_like(val)
