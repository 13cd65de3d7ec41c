"""Counter-based normal draws: the port of ``core/rng.py``'s draw backend.

``normals(key, shape, tag, offset=0, device=..., pass_index=0)`` gives
clipped N(0,1) draws that depend only on (key, tag, global column index,
row, pass).  On a CUDA device they come from kernel K1
(``csrc/normals.cu``, a Philox4x32-10 written by hand); on the CPU from
``normals_plain``, its twin, which computes the same Philox words with
int64 tensors.

The JAX package's default stream is threefry and its Pallas stream is the
TPU hardware PRNG; neither can be reproduced here, so parity with JAX is
by contract (deterministic per key/tag/shape, distinct streams per tag,
|z| <= 3, mean 0 and std 1), and the parity tests inject JAX's draws.

Columns are particles: the counter's first word is the *global* particle
index (``offset`` + column), so a chunked advance draws the same numbers
as an unchunked one.  Rows come four to a Philox call: rows 4q .. 4q+3 of a
column are made from the four words of counter (index, q, pass, 0), where
``pass`` is the pass of the adaptive advance's substep loop (tags 1 and 2
there) and 0 for every other draw.  Words
(0, 1) are one Box-Muller radius and angle and give rows 4q (cos) and 4q+1
(sin); words (2, 3) give rows 4q+2 and 4q+3 alike.  A row count that is no
multiple of four takes the leading rows of the next multiple.

Where the draws are made: on the CPU the advance calls ``normals`` (the
plain twin) and consumes tensors.  On a CUDA device the advance kernel
(``csrc/advance.cu``) makes the same numbers in registers, through the
device functions of ``csrc/philox_normal.cuh`` that K1 is built from, with
the key of ``Key.philox_key(tag)`` and the counter (offset + column,
row // 4, pass, 0); K1 itself then serves the callers that want draws as a
tensor (the advance's parity mode, the tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build

_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
_TWO_PI_F32 = float(np.float32(2.0 * np.pi))
_2M24 = 2.0 ** -24
# the lane layout of a draw (csrc/philox_normal.cuh holds the same numbers)
ROWS_PER_BLOCK = 4      # rows made by one Philox call
ROWS_PER_PAIR = 2       # rows made by one Box-Muller radius


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class Key:
    """Explicit draw key: a run's seed and the sync-step index."""
    seed: int
    step: int = 0

    def philox_key(self, tag: int) -> tuple[int, int]:
        """(seed_lo, seed_hi ^ mix(step, tag)) as two uint32 words."""
        s = self.seed & _MASK64
        mix = _splitmix64((self.step & _MASK64) ^ _splitmix64(tag & _MASK64))
        return s & _MASK32, ((s >> 32) ^ mix) & _MASK32


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for uint32 values held in int64.

    torch has no uint32 multiply-high and a 32x32 product overflows the
    int64 sign bit, so the product is assembled from 16-bit limbs."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    p0 = a_lo * m_lo
    p1 = a_lo * m_hi
    p2 = a_hi * m_lo
    p3 = a_hi * m_hi
    mid = (p0 >> 16) + (p1 & 0xFFFF) + (p2 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p0 & 0xFFFF)
    hi = (p3 + (p1 >> 16) + (p2 >> 16) + (mid >> 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding uint32 words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W0) & _MASK32
        k1 = (k1 + PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def normals_plain(rows: int, cols: int, k0: int, k1: int, offset: int,
                  device, pass_index: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of K1: same counters, same Philox words, same
    transform."""
    i64 = torch.int64
    blocks = -(-rows // ROWS_PER_BLOCK)
    col = (torch.arange(cols, dtype=i64, device=device) + offset) & _MASK32
    blk = torch.arange(blocks, dtype=i64, device=device)
    c0 = col[None, :].expand(blocks, cols)
    c1 = blk[:, None].expand(blocks, cols)
    c2 = torch.full((blocks, cols), pass_index & _MASK32, dtype=i64,
                    device=device)
    zero = torch.zeros((blocks, cols), dtype=i64, device=device)
    w = torch.stack(philox4x32_10(c0, c1, c2, zero, k0, k1), dim=1)
    # (blocks, pair, cols): words (0, 1) and (2, 3) are a radius and an angle
    u1 = 1.0 - (w[:, 0::2] >> 8).to(torch.float32) * _2M24
    u2 = (w[:, 1::2] >> 8).to(torch.float32) * _2M24
    r = torch.sqrt(-2.0 * torch.log(u1))
    angle = _TWO_PI_F32 * u2
    z = torch.stack([r * torch.cos(angle), r * torch.sin(angle)], dim=2)
    z = z.reshape(blocks * ROWS_PER_BLOCK, cols)[:rows]
    return torch.clamp(z, -3.0, 3.0)


def uniforms_plain(n: int, k0: int, k1: int, device,
                   offset: int = 0) -> torch.Tensor:
    """(n,) uniforms in [0, 1): word 0 of Philox4x32-10(counter (offset +
    i, 0, 0, 0)), its top 24 bits times 2**-24, as ``fp::uniform24`` of
    ``csrc/philox_normal.cuh`` makes them in the redistribution kernel and
    in K11's CBL."""
    i64 = torch.int64
    col = (torch.arange(n, dtype=i64, device=device) + offset) & _MASK32
    zero = torch.zeros(n, dtype=i64, device=device)
    w0 = philox4x32_10(col, zero, zero, zero, k0, k1)[0]
    return (w0 >> 8).to(torch.float32) * _2M24


def normals_cuda(rows: int, cols: int, k0: int, k1: int, offset: int,
                 device, pass_index: int = 0) -> torch.Tensor:
    """K1 launch: (rows, cols) float32 on ``device`` (a CUDA device)."""
    out = torch.empty((rows, cols), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _build.NORMALS(out.data_ptr(), rows, cols, k0, k1, offset,
                       pass_index & _MASK32, stream)
    return out


def uniforms(key: Key, n: int, tag: int, offset: int = 0, *,
             device) -> torch.Tensor:
    """(n,) uniforms in [0, 1) of ``tag`` for the particles offset ..
    offset + n - 1 (the CBL's tag 7): ``uniforms_plain`` on any device;
    the kernels that need them make them in registers."""
    k0, k1 = key.philox_key(tag)
    return uniforms_plain(n, k0, k1, torch.device(device), offset)


def normals(key: Key, shape, tag: int = 0, offset: int = 0, *,
            device, pass_index: int = 0) -> torch.Tensor:
    """Clipped N(0,1) draws of ``shape`` (the last axis is the particle
    axis) on ``device``: K1 on CUDA, the plain twin on the CPU.
    ``pass_index`` is the pass of the adaptive advance's substep loop."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    cols = shape[-1]
    rows = 1
    for s in shape[:-1]:
        rows *= s
    k0, k1 = key.philox_key(tag)
    device = torch.device(device)
    if device.type == "cuda":
        z = normals_cuda(rows, cols, k0, k1, offset, device, pass_index)
    elif device.type == "cpu":
        z = normals_plain(rows, cols, k0, k1, offset, device, pass_index)
    else:
        raise ValueError(f"no normals backend for device {device}")
    return z.reshape(shape)
