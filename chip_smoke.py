#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (flexpart_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the hand-written kernels from
flexpart_tpu_torch/csrc/ at first use (into build/kernels/) and drives
the port's stock forward step on the card, in phases:

  1. device   — card name and power limit, torch and CUDA versions;
  2. build    — nvcc for every kernel source, all started together;
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the main path's shapes, with its time and the twin's;
  4. step     — one full step (tables, advance, sampling) on SyntheticMet
                at the bench grid, 2**20 particles, kernels against twins
                with the same draws;
  5. main     — the main path at full width: uniform-wind met on the
                361x181x30 grid, 10 x 2**20 particles in 2**19 chunks, the
                720x360x3 output grid, 14 steps of 900 s (the last three
                sample with the 4-point kernel); launch counts are reset
                just before and read just after.

Prints one JSON object per phase, then a {"kernels": [...]} line, the
nvidia-smi name/power line, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result.  It also fails without a CUDA card,
and when run from a directory that holds nothing else of the repo.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

BENCH_GRID = dict(nx=361, ny=181, nlev=30, dx=1.0, dy=1.0, xlon0=-180.0,
                  ylat0=-90.0, xglobal=True)
N_MAIN = 10 * 2 ** 20
CHUNK = 2 ** 19
N_STEP4 = 2 ** 20
MAIN_STEPS = 14
LSYNC = 900
K1_SHAPE = (6, 2 ** 19)
K1_ATOL = 5e-6
K3_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms, by CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ----------------------------------------------------------------- setup --

def met_fields(kind: str, grid, device, times=(0.0,)):
    """ZFields at each time, on one height grid taken from the first."""
    from flexpart_tpu_torch.met import calcpar, synthetic, verttransform
    met = (synthetic.SyntheticMet(grid) if kind == "synthetic"
           else synthetic.uniform_wind_met(grid, u=10.0, v=1.0))
    out, height = [], None
    for t in times:
        eta = met.fetch(t, device)
        if height is None:
            height = verttransform.compute_heights(grid, eta)
        out.append(calcpar.calcpar(grid, eta, verttransform.process_eta(
            grid, eta, height)))
    return out


def bench_particles(n: int, device, seed: int, old_fraction: float = 0.0):
    """bench.py's start: x in [30, 330], y in [30, 150], z in [10, 8000] m,
    all active, mass 1/n; drawn on the card from a torch.Generator."""
    import torch
    from flexpart_tpu_torch.core.state import empty_particles
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    p = empty_particles(n, device=device)
    itramem = torch.where(torch.rand(n, generator=gen, device=device)
                          < old_fraction, -10800, 0).to(torch.int32)
    return p.replace(x_hi=u(30.0, 330.0), y_hi=u(30.0, 150.0),
                     z=u(10.0, 8000.0),
                     active=torch.ones(n, dtype=torch.bool, device=device),
                     itra=torch.zeros(n, dtype=torch.int32, device=device),
                     itramem=itramem,
                     mass=torch.full((n, 1), 1.0 / n, device=device))


def step_setup(grid):
    from flexpart_tpu_torch.config import OutGrid
    from flexpart_tpu_torch.core.advance import StepConfig, StepParams
    from flexpart_tpu_torch.grid.conccalc import ConcConfig
    from flexpart_tpu_torch.grid.outgrid import OutputGridGeometry
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                     ldirect=1, turbswitch=False, ifine=1, method=0)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=1.0)
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720, numygrid=360,
                 dxout=0.5, dyout=0.5, outheights=(100.0, 1000.0, 50000.0))
    geo = OutputGridGeometry(og, grid)
    ccfg = ConcConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg, npointspec=1,
                      nclassunc=1, nage=1, dxout=og.dxout, dyout=og.dyout,
                      xoutshift=geo.xoutshift, youtshift=geo.youtshift,
                      dx_met=grid.dx, dy_met=grid.dy, ind_samp=0)
    return cfg, prm, og, geo, ccfg


# ---------------------------------------------------------------- phases --

def phase_kernels(device, grid) -> dict:
    """Each kernel against its plain twin at the main path's shapes."""
    import torch
    from flexpart_tpu_torch.core import interp, rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    res = {}

    # K1: (6, 2**19) draws, a chunk of the main path (tag 6), at an offset
    rows, cols = K1_SHAPE
    key = rng.Key(1234, 5)
    k0, k1 = key.philox_key(6)
    off = 3 * cols
    zk = rng.normals_cuda(rows, cols, k0, k1, off, device)
    zp = rng.normals_plain(rows, cols, k0, k1, off, device)
    err = float((zk - zp).abs().max())
    check(err <= K1_ATOL, f"K1 vs twin max abs err {err} > {K1_ATOL}")
    a = rng.normals(key, (8, 4096), 5, device=device)
    b = rng.normals(key, (8, 4096), 5, device=device)
    c = rng.normals(key, (8, 4096), 6, device=device)
    check(torch.equal(a, b), "K1 not deterministic")
    check(not torch.equal(a, c), "K1 tags do not separate streams")
    check(float(zk.abs().max()) <= 3.0, "K1 draws exceed the +-3 clip")
    mean, std = float(a.mean()), float(a.std())
    check(abs(mean) < 0.02 and abs(std - 1.0) < 0.02,
          f"K1 moments mean={mean} std={std}")
    ms = cuda_ms(lambda: rng.normals_cuda(rows, cols, k0, k1, off, device), 50)
    plain_ms = cuda_ms(lambda: rng.normals_plain(rows, cols, k0, k1, off,
                                                 device), 5)
    res["normals"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          mean=mean, std=std)

    # K2: the step tables at the bench grid, f32 and bf16, bitwise
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    tw = (0.3, 0.7, 0.21666666865348816, 0.7833333611488342)
    f3d0, f2d0, f3d1, f2d1 = z0.f3d, z0.f2d, z1.f3d, z1.f2d
    times = {}
    k2_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        tk = interp.quad_tables_cuda(f3d0, f3d1, f2d0, f2d1, *tw, dt)
        tp = interp.quad_tables_plain(f3d0, f3d1, f2d0, f2d1, *tw, dt)
        for name in ("rows", "rowsE"):
            x, y = getattr(tk, name), getattr(tp, name)
            check(x.shape == y.shape == ((grid.nlev - 1) * grid.ny * grid.nx,
                                         64), f"K2 {name} shape {x.shape}")
            bits = torch.int16 if dt == torch.bfloat16 else torch.int32
            diff = x.view(bits) != y.view(bits)
            lanes = torch.nonzero(diff.any(dim=0)).flatten().tolist()
            err = float((x.float() - y.float()).abs().max())
            k2_err = max(k2_err, err)
            check(not lanes, f"K2 {name} {dt} differs from the twin in lanes "
                  f"{lanes}: {int(diff.sum())} values, max abs {err}")
        del tk, tp
        times[dt] = (cuda_ms(lambda: interp.quad_tables_cuda(
            f3d0, f3d1, f2d0, f2d1, *tw, dt), 10),
            cuda_ms(lambda: interp.quad_tables_plain(
                f3d0, f3d1, f2d0, f2d1, *tw, dt), 3))
    res["quad_tables"] = dict(max_abs_err=k2_err, ms=times[torch.bfloat16][0],
                              plain_ms=times[torch.bfloat16][1],
                              f32_ms=times[torch.float32][0],
                              f32_plain_ms=times[torch.float32][1])
    del z0, z1

    # K3: sampling of 10 x 2**20 particles, both paths
    _, _, og, geo, ccfg = step_setup(grid)
    p = bench_particles(N_MAIN, device, seed=7, old_fraction=0.5)
    p = p.replace(itra=torch.full_like(p.itra, 14400),
                  itramem=p.itramem + 14400 - 3600)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    worst = 0.0
    k3_ms = {}
    for kp in (False, True):
        cfg = ccfg.replace(kernel_possible=kp)
        gk = zero_accumulators(geo, 1, 1, device=device).gridunc
        gp = zero_accumulators(geo, 1, 1, device=device).gridunc
        cc.conccalc_cuda(gk.view(-1, 1), p, 14400, lage, oh, 1.0, None, cfg)
        cc.conccalc_plain(gp.view(-1, 1), p, 14400, lage, oh, 1.0, None, cfg)
        d = (gk - gp).abs()
        worst = max(worst, float(d.max()))
        check(bool(torch.all(d <= K3_RTOL * gp.abs())),
              f"K3 kernel_possible={kp} exceeds rtol {K3_RTOL}: "
              f"max rel {float((d / gp.abs().clamp(min=1e-30)).max())}")
        check(abs(float(gk.sum()) - float(gp.sum())) <= 1e-5 * float(gp.sum()),
              "K3 total differs")
        k3_ms[kp] = (cuda_ms(lambda: cc.conccalc_cuda(
            gk.view(-1, 1), p, 14400, lage, oh, 1.0, None, cfg), 10),
            cuda_ms(lambda: cc.conccalc_plain(
                gp.view(-1, 1), p, 14400, lage, oh, 1.0, None, cfg), 3))
    res["conccalc"] = dict(max_abs_err=worst, ms=k3_ms[True][0],
                           plain_ms=k3_ms[True][1],
                           single_index_ms=k3_ms[False][0],
                           single_index_plain_ms=k3_ms[False][1])
    return res


def phase_step(device, grid) -> dict:
    """One full step at 2**20 particles: kernels vs plain twins, same draws."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, rng
    from flexpart_tpu_torch.core.state import Particles
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, prm, og, geo, ccfg = step_setup(grid)
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    n = N_STEP4
    n_chunks = n // CHUNK
    p = bench_particles(n, device, seed=11)
    key = rng.Key(99, 0)
    draws = {tag: rng.normals(key, (rows, n), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    itime, mem1 = 3600, 10800
    ccfg = ccfg.replace(kernel_possible=False)

    # kernels: the entry points a user calls
    pk, dk = advance.advance_chunked(p, z0, z1, itime, 0, mem1, key, cfg,
                                     prm, n_chunks, draws=draws)
    acc = zero_accumulators(geo, 1, 1, device=device)
    acc = cc.conccalc(acc, pk, z0, itime + LSYNC, lage, 1.0, ccfg, oh)
    gk = acc.gridunc

    # plain twins: the same loop with the twin tables and twin sampling
    tw0, tw1, ew0, ew1, _ = advance._time_weights(itime, 0, mem1, prm, cfg)
    tables = interp.quad_tables_plain(z0.f3d, z1.f3d, z0.f2d, z1.f2d, tw0,
                                      tw1, ew0, ew1, cfg.table_dtype)
    parts = []
    for c in range(n_chunks):
        a, b = c * CHUNK, (c + 1) * CHUNK
        q, _ = advance.advance_all(p.rows(a, b), z0, z1, itime, 0, mem1, key,
                                   cfg, prm, tables=tables,
                                   draws={t: v[:, a:b] for t, v in draws.items()},
                                   offset=a)
        parts.append(q)
    pp = Particles.cat(parts)
    gp = zero_accumulators(geo, 1, 1, device=device).gridunc
    cc.conccalc_plain(gp.view(-1, 1), pp, itime + LSYNC, lage, oh, 1.0, None,
                      ccfg)

    dx = float(((pk.x - pp.x).abs()).max())
    dy = float(((pk.y - pp.y).abs()).max())
    dz = (pk.z - pp.z).abs()
    check(dx <= 1e-4 and dy <= 1e-4, f"step: x/y differ by {dx}/{dy}")
    check(bool(torch.all(dz <= 1e-2 + 1e-4 * pp.z.abs())),
          f"step: z differs by {float(dz.max())}")
    for f in ("cbt", "active", "itra"):
        check(torch.equal(getattr(pk, f), getattr(pp, f)), f"step: {f} differs")
    check(int(dk.n_active) == n and int(dk.nan_count) == 0, "step: lost particles")
    gd = (gk - gp).abs()
    check(bool(torch.all(gd <= K3_RTOL * gp.abs())), "step: gridunc differs")
    check(abs(float(gk.sum()) - 1.0) < 1e-3, f"step: sampled mass {float(gk.sum())}")
    return dict(n=n, max_dx=dx, max_dy=dy, max_dz=float(dz.max()),
                gridunc_max_abs_err=float(gd.max()), mass=float(gk.sum()))


def phase_main(device, grid, kernels) -> dict:
    """The bench.py step at full width, 14 steps; launch counts reset just
    before and read just after."""
    import torch
    from flexpart_tpu_torch.core import advance, rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, prm, og, geo, ccfg = step_setup(grid)
    (z0,) = met_fields("uniform", grid, device)
    p = bench_particles(N_MAIN, device, seed=0)
    conc = cc.make_conccalc(og.outheights)
    acc = zero_accumulators(geo, 1, 1, device=device)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    n_chunks = max(1, N_MAIN // CHUNK)
    finite = torch.ones((), dtype=torch.bool, device=device)
    diags, step_s = [], []

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t_all = time.perf_counter()
    for i in range(MAIN_STEPS):
        t0 = time.perf_counter()
        it = i * LSYNC
        p, diag = advance.advance_chunked(p, z0, z0, it, 0, 86400,
                                          rng.Key(2, i), cfg, prm, n_chunks)
        c = ccfg.replace(kernel_possible=cc.kernel_possible_at(it + LSYNC, 0))
        acc = conc(acc, p, z0, it + LSYNC, lage, 1.0, c)
        finite &= (torch.isfinite(p.x).all() & torch.isfinite(p.y).all()
                   & torch.isfinite(p.z).all())
        diags.append(diag)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t_all
    launches = {k.name: k.launches for k in kernels}

    for i, d in enumerate(diags):
        check(int(d.n_active) == N_MAIN, f"main step {i}: n_active {int(d.n_active)}")
        check(int(d.nan_count) == 0, f"main step {i}: nan_count {int(d.nan_count)}")
    check(bool(finite), "main: non-finite positions")
    total = float(acc.gridunc.sum(dtype=torch.float64))
    check(abs(total - MAIN_STEPS) <= 1e-3 * MAIN_STEPS,
          f"main: sampled mass {total} != {MAIN_STEPS}")
    for name, c in launches.items():
        check(c > 0, f"main: kernel {name} was never launched")
    steady = step_s[1:]
    rate = N_MAIN * len(steady) / sum(steady)
    return dict(n=N_MAIN, steps=MAIN_STEPS, n_chunks=n_chunks,
                wall_s=wall, first_step_s=step_s[0],
                steady_step_s=sum(steady) / len(steady),
                particle_steps_per_s=rate, sampled_mass=total,
                kernel_steps=sum(cc.kernel_possible_at(i * LSYNC + LSYNC, 0)
                                 for i in range(MAIN_STEPS)),
                launches=launches)


# ------------------------------------------------------------------ main --

def main() -> int:
    if not (ROOT / "flexpart_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke.py must run from a checkout of the repo "
                         "(flexpart_tpu_torch/ not found beside it)")
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this smoke run needs an NVIDIA card")
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.met.synthetic import make_grid

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})

    kernels = list(_build.KERNELS)
    build_s = _build.build_all(kernels)
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln] for k in kernels}
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

    grid = make_grid(**BENCH_GRID)
    t0 = time.perf_counter()
    kres = phase_kernels(device, grid)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, **kres,
          "power_limit": smi})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sres = phase_step(device, grid)
    emit({"phase": "step", "seconds": time.perf_counter() - t0, **sres})
    torch.cuda.empty_cache()

    mres = phase_main(device, grid, kernels)
    emit({"phase": "main", **mres, "device": name, "power_limit": smi})

    src = "flexpart_tpu_torch/csrc/{}.cu"
    replaces = {"normals": ("flexpart_tpu/core/rng.py:61", "pallas"),
                "quad_tables": ("flexpart_tpu/core/interp.py:457", "XLA"),
                "conccalc": ("flexpart_tpu/grid/conccalc.py:78", "XLA")}
    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": src.format(k.name),
         "replaces": replaces[k.name][0], "tpu_route": replaces[k.name][1],
         "launches": mres["launches"][k.name],
         "max_abs_err": kres[k.name]["max_abs_err"],
         "ms": kres[k.name]["ms"], "plain_ms": kres[k.name]["plain_ms"]}
        for k in kernels]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
