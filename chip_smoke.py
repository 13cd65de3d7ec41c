#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (flexpart_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc; builds the hand-written kernels from
flexpart_tpu_torch/csrc/ at first use (into build/kernels/) and drives
the port's stock forward step on the card, in phases:

  1. device   — card name and power limit, torch and CUDA versions;
  2. build    — nvcc for every kernel source, all started together (K4
                and K11 in three parts each, one nvcc a part; each
                kernel's end in the line), and cuobjdump of the libraries
                whose compiled code the bounds read, each as soon as it is
                built, all of it before any timing (the `disassembly`
                line: what is left after the build);
  3. kernels  — each kernel against its plain PyTorch twin on the card, at
                the main path's shapes, with its time, the twin's, its
                bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s,
                whichever is larger) and, where one PyTorch call computes
                the same function, that call's time (the normals kernel
                and its library call take some 10 us, less than a launch
                costs the host, so both are timed as replays of a CUDA
                graph of 50 launches); the sampling on both paths, on an
                unordered and on a cell-ordered ensemble, all particles
                old and half of them, with the global atomics it would
                make without its per-warp sums (the (particle, target)
                pairs) and with them (the distinct (warp, target) pairs);
                the cell-order sort must give the stable argsort of the
                cell keys as its permutation and the plain version's
                particles, bitwise, on four inputs (shuffled, 16 steps
                after a sort, every slot unscheduled, a release step) and
                twice in a row, and the advance must commute with it; the
                advance's POLAR instantiation on 10 x 2**20 particles over
                the whole sphere (both caps, some crossing a pole); the
                convection columns (K6) on SyntheticMet's two met times
                and on the moist-unstable sounding at every column, each
                through five steps of the flux memory's feedback, every
                output bitwise, with K6's layout on the card (shared bytes
                per column, columns per block, resident warps per SM,
                registers), and the same two cases on two taller grids
                (L1 = 68 and 126: several levels per lane); and the
                redistribution (K7) of 10 x 2**20 particles against both
                cases' matrices, with injected uniforms and its own, z
                bitwise and the moved counts equal, as drawn and in cell
                order (K5, the run's order), the sorted result equal to
                the unsorted one through perm, each timed beside its bound;
                the deposition kernels on 10 x 2**20 particles over the
                globe with two species: the wet pass (K9) and the decay
                and dry pass (K10) against their plain chains, bitwise,
                on SyntheticMet's fields and on the same fields with every
                cloud class and a temperature across the ice ramp, as
                drawn and in cell order, and the deposit scatter (K8) of
                both deposits against the float64 sum of its pairs, and on
                two plumes in the sim phase's first release box (every
                particle depositing, and 5% of them), with index_add_ of
                its pairs as its library call (K3's too, on the pairs of
                each of its cases); the advance's SETTLING instantiation
                beside the stock one on the same 10 x 2**20 particles, a
                third of them a settling aerosol; the decay and dry pass's
                T_BELOW instantiation beside it on the same particles; and
                the adaptive step (K11) on 10 x 2**20 particles over the
                boundary layer of the whole sphere, as drawn and in cell
                order, with its passes, the lane efficiency of its refilled
                lanes beside the warp efficiency that one thread per
                particle would have, and its bound from the compiled
                kernel's instructions per pass body; and on the edges of
                the refill: 17, 257 and 10,000 particles, 2**16 that all
                start above h, one with the most passes among 63 with none;
                K11's CBL instantiation (the skewed convective boundary
                layer, ifine 11) bitwise against its plain version on 10 x
                2**20 boundary-layer particles, SyntheticMet's fields with
                a strong CBL over the eastern half, in cell order (timed
                as drawn too), beside the stock K11, with its layout
                (blocks an SM, the register cap, ptxas's registers and
                spills) and its bound charging the skewed work at the
                cheapest paths of the CBL part built with the skewed
                substep as a call (cbl_calls_build); K4's NESTS
                instantiation with two nested windows, each with its own
                jet (a third of the particles in the inner one, a third in
                the outer one only), bitwise against its plain version
                with injected draws, timed beside the stock K4 on the same
                particles; and a backward run's kernels: K3's BKDEP
                (times max(xscav, 0)) and COUNT instantiations within
                K3's tolerance on 10 x 2**20 old particles with two
                species, both paths, beside the stock K3 and index_add_
                of their pairs; K7's BACKWARD instantiation (the
                transposed matrix) bitwise on both convection cases; K9's
                and K10's BKDEP instantiations (the scavenging factor of
                a fresh particle) bitwise on the deposition particles,
                half of them fresh; and the advance at ldirect = -1: stock
                K4 and POLAR on 10 x 2**20 particles with injected draws,
                K11 and K11 CBL on 2**20 boundary-layer particles, all
                bitwise, each beside the forward instantiation; K9's
                cloud-water instantiations (use_clwc: the in-cloud rule's
                cloud water from the column cloud water ctwc at the
                particle's cell): K9 CLWC on the deposition particles, on
                SyntheticMet's fields classified by their cloud water and
                on every cloud class with a seeded ctwc, as drawn and in
                cell order, and K9 BKDEP x CLWC on both in cell order,
                half the particles fresh, all bitwise, each timed beside
                K9 (K9 BKDEP) on the same particles with its bound from
                the compiled CLWC section;
  3b. kernels_oh_split — K12, the OH reaction, bitwise against its plain
                version on the deposition particles (10 x 2**20, two OH
                species, one with the power N = 2) at a daylight step of
                the synthetic climatology, as drawn and in cell order, with
                its layout (shared bytes, blocks per SM, registers); K13, the
                splitting, bitwise (every field and the counts) on 12 x
                2**20 slots: half free with a quarter of the live ones due,
                a quarter free with three quarters due (the capacity
                guard), and after a cell-order sort with its shuffled
                origin; its library call torch.cumsum of the two flag
                arrays, the scan half;
  3c. kernels_domainfill — on the sim_domainfill phase's fill (10 x 2**20
                particles in 11 x 2**20 slots over the 30 W - 45 E, 30 -
                75 N window, made once by init_domainfill and timed):
                K14, the boundary step, bitwise (every field, the
                accumulator, the counts) with MDOMAINFILL 1 and 2, the
                particles moved half a cell (some out of the window), in
                cell order with their origin, the accumulator up to six
                particle masses a site; its library call torch.cumsum of
                the free flags; K15, the receptors, bitwise at the 32
                receptors on the fill, with every live particle at 0-100
                m (surface) and with a tenth within half a kernel width
                of a receptor (at_receptors), its library call torch.mm
                of the (R, N) weights; K16, the fluxes, on the particles
                moved up to 1.5 cells in the step (K15 and K16 timed by
                CUDA graphs, per launch by the profiler, bounds by need,
                edge cases of 1 to 2**20 + 1 slots untimed), and K17, the
                initial-condition scatter
                (linit_cond 1) on the deposition particles, a tenth of
                them ended, all of them, and a tenth moved into a plume of
                120 cells, each against the float64 sum of their
                pairs (K8's rule), their library call index_add_
                of the pairs;
  4. step     — one full step (tables, advance, sampling) on SyntheticMet
                at the bench grid, 2**20 particles, kernels against twins
                with the same draws; and the advance kernel with its draws
                made in registers against the same kernel fed the normals
                kernel's draws, bitwise;
  5. reorder  — what the cell order is worth and how fast it decays: the
                advance and the sampling timed 0 to 64 steps after a sort,
                the sort timed on a shuffled and on a nearly ordered
                ensemble, on SyntheticMet and on the main path's uniform
                wind, and from these the device time per step for a sort
                every 1, 2, 4, ... 64 steps;
  6. main     — the main path at full width: uniform-wind met on the
                361x181x30 grid, 10 x 2**20 particles, the 720x360x3
                output grid, 33 steps of 900 s (from the twelfth on they
                sample with the 4-point kernel), the particles sorted by
                cell every REORDER_EVERY = 16 steps; launch counts are
                reset just before and read just after;
  7. profile  — REORDER_EVERY more steady steps (one sort among them)
                under torch.profiler: CUDA launches per step, device time
                by kernel with the sort's share, device busy share;
  8. sim      — the port's Simulation.run at full width with the default
                Command (convection and subgrid orography on) and two
                species, the default tracer and a Cs-137-like aerosol that
                decays and deposits wet and dry (no settling): 10 x 2**20
                particles released over the first hour from one box at
                40-42 N (both species) and a second in SyntheticMet's
                storm band (the aerosol only, where it rains), three
                hours on SyntheticMet on the 361x181x30 grid, which reaches
                the poles (the advance's POLAR instantiation), hourly npz
                (and netCDF where h5py imports) output on the 720x360x3
                grid; twice with one seed: the runs must end in bitwise
                equal particles, all particles active, the tracer's mass
                recovered from the last file 1 within 1e-3, the aerosol's
                wet and dry deposits above 0 and its budget (airborne +
                wet + dry = released) within 1e-3, the deposition grids
                of the two runs within rtol 1e-5; per step, the columns
                that convect and the particles convection moved.  The first run carries no
                probe and is timed as a whole; the second, under
                torch.profiler and synchronised at the top of every step,
                gives the section timers, the step time during and after
                the release, the device time of each kernel per call, the
                sorts, and the share of active particles out of cell order
                at the top of each step, and keeps the ensemble, the met
                fields and the flux memory of one release step and of one
                steady step: on those, K9, K10, K8, K2, K5, K6, K7, K3 and
                K4 (injected draws) are held against their plain versions
                at the kernels phase's tolerances (K9 once more with the
                step's particles put in the storm band where fewer than 1%
                of the active ones are scavenged), and K7 once more with the step's
                particles put in its convecting columns (the plume lies
                outside SyntheticMet's convecting bands), where it must
                move some, as put and in cell order, each timed beside
                its bound;
  8b. sim_npz — the command line, ``python -m flexpart_tpu_torch
                pathnames``, run in this process through its main() on a
                job directory the script writes: COMMAND, RELEASES,
                SPECIES and OUTGRID stating the sim phase's configuration
                (checked against it), and the sim phase's met as npz
                archives of the port's save_eta_npz (one per hour over the
                run and the reader's look-ahead, written from threads and
                timed apart).  The default Command writes the reference's
                unformatted files as well.  Run once, timed as the sim
                phase's run A; every kernel of the sim path launched, the
                same launch counts as run A, the particles bitwise equal
                to run A's, the npz files' keys bitwise but the sampled
                and deposited fields (float atomics: within K3's and K8's
                rtol, and reported bitwise or not), the header and every
                grid_conc_ file read back equal to the npz of its step;
 8c. sim_grib — sim_npz's job on ECMWF-style GRIB2 files of the sim
                phase's met (the 29 model levels top-down with the hybrid
                coefficients as pv, the surface set in the accumulations
                that met/gribmet.py converts; about 190 messages a file,
                written from threads and timed apart), read by the port's
                decoder (built from native/gribdec/gribdec.cpp) in the met
                reader thread: run once through main(), the banner, the
                sim phase's launch counts, every particle active and
                finite, the tracer's mass and the aerosol's budget; the
                fields GribMet.fetch returns written with save_eta_npz,
                and the same job on those archives must end in the same
                particles bit for bit; the read split into scan, decode,
                assembly and the copy to the card;
 8d. sim_gfs  — the sim phase's configuration through the command line's
                build_simulation on GFS-style GRIB2 files (NCEP's
                1.0-degree grid from 0 E, 26 isobaric levels from 1000 to
                10 hPa, SyntheticMet interpolated in ln p; a plateau whose
                levels below ground collapse, cloud water and rain over
                the storm box), twice with one seed: use_clwc from
                GfsMet's sumclouds, so K9 CLWC at every step and the stock
                K9 never; K9 CLWC bitwise against its plain version on the
                kept steps, the scavenged pairs per rule (the in-cloud
                rule's above 0), the budget, the below-ground cells;
 9. sim_adaptive — Simulation.run at full width with Command(ctl=5.0)
                (the adaptive step: K11 every step, K4 never) and two boxes
                of one species each, so that the aerosol settles: the
                tracer from 40-42 N and a Cs-137-like aerosol with a density
                (about 7 mm/s) from the storm band; three hours, twice with
                one seed: bitwise equal particles, the aerosol's budget
                within 1e-3 and deposits above 0, the tracer's mass
                recovered; the passes per boundary-layer particle, K11's
                lane efficiency and the warp efficiency of every step (run
                B); K11, K4 SETTLING and
                K10 T_BELOW against their plain versions on a release step
                and a steady step, and K11 once more without settling on
                the same particles and key: the aerosol ends lower, the
                tracer the same;
 10. sim_cbl  — sim_adaptive's run with Command(cblflag=1, ctl=5.0) (ifine
                11, K11's CBL instantiation with settling), twice with one
                seed: bitwise equal particles and NaN redraw counts, the
                budget, the tracer's mass; per step the share of the
                boundary-layer particles in the skewed zone and K11's lane
                efficiency; K11 CBL bitwise against its plain version on
                every 8th particle of a release step and a steady step,
                timed on all of them beside its bound there (the kernels
                phase's count on the step's particles);
 11. sim_nested — the sim phase's run with one SyntheticMet nest of 0.25
                degrees over 10 W-20 E, 30-60 N with a stronger jet than
                the mother's (the first box inside it, the storm box
                outside), twice with one seed: bitwise equal particles,
                the budget, the tracer's mass; per step the share of the
                particles the nest samples; K2 per call (twice a step) and
                K4 NESTS per call, K4 NESTS bitwise against its plain
                version on a release step and a steady step;
 12. sim_backward — a backward Simulation.run (ldirect=-1) at full
                width: 10 x 2**20 particles released over the last hour
                from a receptor box in the storm band, the sim phase's two
                species, three hours of 900 s steps back on the sim
                phase's grid, convection on (K7 BACKWARD), hourly output
                (grid_time_ netCDF, residence times in s), twice with one
                seed: every kernel of the path launched, bitwise equal
                particles, positive finite output, no deposit gridded, the
                tracer's mass kept and the aerosol's depleted;
 13. sim_bkdep — one short backward run each of ind_receptor 3 (WETBKDEP,
                K9 BKDEP) and 4 (DRYBKDEP, K10 BKDEP), 2**20 particles,
                four steps: every factor assigned after the first step,
                positive wet factors in the storm band, the dry factor the
                species' dryvel, wetscav_precip.txt written, K3 BKDEP
                sampling; WETBKDEP once more with use_clwc (K9 BKDEP x
                CLWC);
 14. sim_oh_split — particle dumps, warm start, checkpoints, the OH
                reaction (K12) and particle splitting (K13) through
                Simulation.run at full width: the sim phase's
                configuration on 2020-07-01 from 10:00 UTC (daylight, so
                that the hourly OH is not zero), species 0 the REACT
                species, capacity 12 x 2**20, itsplit 3600, ipout 2; run A
                straight through with a checkpoint at 3600 s (timed,
                launch counts reset: K12 every step, K13 at both outputs,
                the first hitting the capacity guard); run B resumed from
                it, its particles bitwise and its partposit_end byte for
                byte A's, K12 and K13 held bitwise against their plain
                versions on its own steps (granted = min(due, free), the
                live mass within rtol 1e-6); run C a warm start (ipin=1)
                from A's partposit_end for one hour, the dumped particles'
                count and masses the file's;
 14b. sim_domainfill — a regional domain fill (MDOMAINFILL=1) through
                Simulation.run at full width: 10 x 2**20 particles of air
                over the 30 W - 45 E, 30 - 75 N window in 11 x 2**20 slots,
                the default Command for three hours on the sim phase's
                grid, iflux = 1, 32 receptors inside the window, an
                OUTGRID_NEST at 0.25 degrees over 10 W - 20 E, 40 - 60 N;
                twice with one seed (run B from a copy of A's fill):
                K14 every step, K15 and the nest's K3 (conccalc.nest) at
                every sampling, K16 every step; the filled air mass equal
                to airmass_total, particles killed and emitted at the
                boundary, every live one inside the window, the receptor,
                flux and nest files read back; in a third run (bitwise
                run B) K15 and K16 held against their plain versions on
                every call, with each call's bound by need;
 14c. sim_initcond — sim_backward's run with linit_cond = 1 and iout = 5
                (plume trajectories, clustered on the card), twice with
                one seed: K17 every step and at the end, grid_initial_*
                holding every particle's mass over its density once,
                trajectories.txt with a line per output; K17's bound per
                call from the particles each call masked and the grid
                rows their pairs hit, counted in a third run (untimed,
                unprofiled, bitwise run B);
 15. legacy   — the matched-RNG validation path (Simulation(legacy_rng=
                True)) has no kernel and runs on the CPU only: on the card
                the constructor and advance_all must refuse it by name.
Every sim path but sim_npz, sim_grib and sim_oh_split (each held to
another run instead) runs through one two-run check (run_twice): the
launch counts of run A, each of its kernels launched and K5 once per sort,
the particles, files and budget, and run B's particles, nan counts and
sorts bitwise equal to run A's, its grids within the kernels' tolerances.

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
MAIN_STEPS = 33          # step 0 warms up; 32 steady steps, two sorts
DECAY_STEPS = 64         # steps followed after a sort in the reorder phase
SORT_INTERVALS = (1, 2, 4, 8, 16, 32, 64)
LSYNC = 900
K1_SHAPE = (6, 2 ** 19)
K1_ATOL = 5e-6
K3_RTOL = 1e-5
# K4 against the plain advance: positions in grid units, z in metres (plus
# 1e-4 relative), velocities and mesoscale memories in m/s.  The two run
# the same float32 operations in the same order and have agreed bitwise on
# the H100; the room is for a toolkit whose expf/powf/cosf differ by an ulp
# from the ones torch was built with, which a 900 s step multiplies.  cbt
# and active hinge on comparisons of such floats: at most K4_FLAG_SHARE of
# the particles may differ there.
K4_XY_ATOL = 1e-4
K4_Z_ATOL, K4_Z_RTOL = 1e-2, 1e-4
K4_V_ATOL, K4_V_RTOL = 1e-5, 1e-4
K4_FLAG_SHARE = 1e-5
# the card's peaks (NVIDIA H100 SXM data sheet) for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the rate at which the card runs instructions: one a clock on each of
# its 16,896 float32 lanes (132 SMs x 4 schedulers x 32), the float32 peak
# without its count of two operations per fused multiply-add.  A count of
# SASS instructions (K11, K4's SETTLING) is held against it: the kernels
# build with -fmad=false, and no instruction takes less than a lane-clock.
INSTRUCTIONS_PER_S = F32_OPS_PER_S / 2
# operations per element, counted from the sources.  A draw: a quarter of
# a Philox call (10 rounds of 2 multiply-high, 2 multiply-low, 4 xor and 2
# add: 100) and half a Box-Muller pair (2 shifts, 2 conversions, logf about
# 25, sqrtf about 10, sincosf about 40, 5 multiplies and subtractions, 8 for
# the clips: about 95), with the stores and the loop about 80; the six rows
# of K1_SHAPE take two calls and three pairs.  It was 175 while each draw
# had a Philox call and a logf/sqrtf/cosf of its own.  A sampled particle:
# 60 for its cell and weights and, on the 4-point path, four rounds of a
# warp match and a shuffle loop of about 60 each.
K1_OPS_PER_DRAW = 80
K2_OPS_PER_LANE = 12
K3_OPS_PER_PARTICLE = 300
K4_OPS_PER_PARTICLE = 1800
K5_OPS_PER_PARTICLE = 60
# K6 against its plain pipeline: every output bitwise.  Both add each level
# sum in level order and spell every operation alike.
CONV_TW = (0.75, 0.25)      # the step's time weights in the kernels phase
CONV_SPINUP = 5             # steps of cbmf feedback before the comparison
# taller grids for K6's levels beyond one per lane: nlev 80 and 150 give
# L1 = 68 and 126 (nconvlev_from_grid), on 73 x 37 columns
K6_TALL = (80, 150)
K6_TALL_NX, K6_TALL_NY = 73, 37
# operations of K6 per column, counted from csrc/convection.cu: the
# entrainment row and the normalisation scan (about 60 per (i, j)), the
# flux sums (MENT's two column prefix sums and the three row sums of
# M above, FUP and FDOWN: 5 per (i, j)), the rows of fmassfrac (4 per
# (i, j)), the profiles and the lifted parcel (about 200 per level)
def k6_ops_per_column(L1: int) -> int:
    return 69 * L1 ** 2 + 200 * L1


K7_OPS_PER_PARTICLE = 30    # the column, the level search's setup, the store
K7_OPS_PER_LIVE_LEVEL = 12  # the level search and the cumulative row
K4_POLAR_OPS = 150          # per cap particle: the six transcendentals and
#                             the plane arithmetic, at both call sites
# K4's SETTLING instantiation and K11, the adaptive step, against their
# plain twins: every output bitwise (they run the same float32 operations,
# -fmad=false, and make the same draws, K11 those of each pass).  Settling's
# work in K4 and K11's per pass are read from the compiled kernels
# (settling_instructions, k11_instructions); the rest of a particle's work
# is K4's.
# the deposition kernels (K8-K10).  K9 and K10 run the plain versions'
# float32 operations in their order with the same expf/powf/sqrtf, and are
# held bitwise; where a toolkit's powf or expf differs by an ulp from the
# one torch was built with, each value must stay within the rtol below and
# the differing values are counted.  K8's float atomics are held against
# the float64 sum of its pairs: within max(pairs in the cell * 2**-24,
# K8_RTOL).  Operations, counted from the sources: K8 as K3 (a sampled
# particle's four rounds of a warp match and a shuffle loop); K10 the
# weights (about 40), a species' two or three expf and the products (about
# 60).  K9's are read from the compiled kernel (k9_bound): the
# instructions of its own code for every particle, and those of each
# scavenging path's function for every (particle, species) that calls it.
K8_RTOL = 1e-5
K9_RTOL = 1e-5
K10_RTOL = 1e-5
K8_OPS_PER_PARTICLE = 300
K10_OPS_PER_PARTICLE = 40
K10_OPS_PER_SPECIES = 60
# the functions of csrc/wetdepo.cu that a scavenged particle calls: each
# rule, the cloud water and the removal
K9_PATHS = ("lam_below_gas", "lam_below_aerosol", "cloud_water",
            "lam_in_cloud_aerosol", "lam_in_cloud_gas", "wet_removal")
# K9 CLWC's: the column cloud water in place of the rate's
K9_CLWC_PATHS = tuple("cloud_water_column" if f == "cloud_water" else f
                      for f in K9_PATHS)
# the sim phase holds K9 once more in the storm band where fewer than this
# share of a kept step's active particles is scavenged
SIM_MIN_RAINED = 0.01
K4_CASES = {"stock": dict(turbswitch=False, ifine=1, met_bf16=True),
            "turb_ifine4": dict(turbswitch=True, ifine=4, met_bf16=True),
            "f32_tables": dict(turbswitch=False, ifine=1, met_bf16=False)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_by_entry(build_log: str) -> dict:
    """{kernel entry: registers, stack frame, spill stores and loads in
    bytes} from nvcc's -Xptxas -v lines; a template instantiation is named
    by its bool and int arguments (advance_kernel<1,0,1,0,0> is BF16, not
    TS, POLAR, not SETTLING, not NESTS; K11's second argument is the
    turbulence, 0 Hanna1, 1 TS, 2 CBL)."""
    import re
    out, entry, props = {}, None, None
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            base = re.search(r"\d([a-z][a-z_]*_kernel)", name)
            flags = re.findall(r"L[bi](\d+)E", name)
            entry = (base.group(1) if base else name) \
                + (f"<{','.join(flags)}>" if flags else "")
            out[entry] = {"mangled": name}
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and entry is not None and props == out[entry]["mangled"]:
            out[entry].update(stack=int(m[1]), spill_stores=int(m[2]),
                              spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            out[entry]["registers"] = int(m[1])
    for v in out.values():
        v.pop("mangled")
    return out


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


def cuda_graph_ms(fn, reps: int = 50) -> float:
    """Mean device time of fn() in ms when ``reps`` calls are captured into
    one CUDA graph and replayed: for a kernel shorter than the host takes to
    launch it, which event timing around a Python loop cannot see.  The
    capture is thread_local: a Simulation's met reader thread may use the
    card meanwhile (a call intercepted in a run)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, 5) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(n_bytes: float, n_ops: float, n_instructions: float = 0) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate, plus instructions
    read from a compiled kernel over the rate the card runs them."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / F32_OPS_PER_S + n_instructions / INSTRUCTIONS_PER_S) * 1e3
    out = dict(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=int(n_bytes), bound_operations=int(n_ops))
    if n_instructions:
        out["bound_instructions"] = int(n_instructions)
    return out


# ----------------------------------------------------------------- setup --

_MET = {}


def met_fields(kind: str, grid, device, times=(0.0,)):
    """ZFields at each time, on one height grid taken from the first;
    made once per (kind, grid, device, times) in a run (SyntheticMet's
    fields are numpy work on the host), which no caller changes."""
    key = (kind, repr(grid), str(device), tuple(times))
    if key not in _MET:
        _MET[key] = _met_fields(kind, grid, device, times)
    return list(_MET[key])


def _met_fields(kind: str, grid, device, times):
    """``kind``: "synthetic", "synthetic_clwc" (SyntheticMet's fields with
    the readclouds classification of its cloud water, use_clwc),
    "synthetic_pv" (with the potential vorticity, calcpv, as a Simulation
    processes them) or "uniform"."""
    from flexpart_tpu_torch.met import (calcpar, calcpv, synthetic,
                                        verttransform)
    met = (synthetic.SyntheticMet(grid) if kind.startswith("synthetic")
           else synthetic.uniform_wind_met(grid, u=10.0, v=1.0))
    out, height = [], None
    for t in times:
        eta = met.fetch(t, device)
        if height is None:
            height = verttransform.compute_heights(grid, eta)
        pvh = calcpv.calcpv(grid, eta) if kind.endswith("_pv") else None
        out.append(calcpar.calcpar(grid, eta, verttransform.process_eta(
            grid, eta, height, pvh=pvh, use_clwc=kind.endswith("_clwc"))))
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


def edge_particles(n: int, device, seed: int, itime: int, hmix_at):
    """bench_particles with what the advance branches on: half the
    particles released at ``itime`` (fresh), 1/64 not scheduled, the first
    4096 spread along the poles and the date line, and a quarter moved
    below the local mixing height ``hmix_at(particles)`` so that every
    boundary-layer branch is taken."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    def u(lo, hi, m=n):
        return torch.rand(m, generator=gen, device=device) * (hi - lo) + lo

    x, y = p.x_hi.clone(), p.y_hi.clone()
    m = 1024
    y[0:m] = u(0.0, 0.02, m)                  # south pole
    y[m:2 * m] = u(179.98, 180.0, m)          # north pole
    x[2 * m:3 * m] = u(0.0, 0.01, m)          # date line, west side
    x[3 * m:4 * m] = u(359.99, 360.0, m)      # date line, east side
    fresh = u(0.0, 1.0) < 0.5
    p = p.replace(x_hi=x, y_hi=y)
    z = torch.where(u(0.0, 1.0) < 0.25, u(0.0, 1.0) * hmix_at(p), p.z)
    return p.replace(
        z=z, x_lo=u(-1e-6, 1e-6), y_lo=u(-1e-6, 1e-6),
        itramem=torch.where(fresh, itime, itime - 7200).to(torch.int32),
        itra=torch.full_like(p.itra, itime),
        up=u(-1.0, 1.0), vp=u(-1.0, 1.0), wp=u(-1.0, 1.0),
        usig=u(-0.3, 0.3), vsig=u(-0.3, 0.3), wsig=u(-0.01, 0.01),
        cbt=torch.where(u(0.0, 1.0) < 0.1, -1, 1).to(torch.int8),
        active=u(0.0, 1.0) >= 1.0 / 64)


def compare_particles(pk, pp, what: str, nxm: float) -> dict:
    """K4's particles against the plain advance's, by the K4_* tolerances.
    Positions are compared where both kept the particle (one that left the
    grid is dropped wherever it went), x as a distance on the cyclic axis."""
    import torch
    n = pk.capacity
    both = pk.active & pp.active
    ddx = (pk.x - pp.x).abs()
    dx = float(torch.minimum(ddx, nxm - ddx)[both].max())
    dy = float((pk.y - pp.y).abs()[both].max())
    check(dx <= K4_XY_ATOL and dy <= K4_XY_ATOL,
          f"{what}: x/y differ by {dx}/{dy}")
    dz = (pk.z - pp.z).abs()
    check(bool(torch.all(dz <= K4_Z_ATOL + K4_Z_RTOL * pp.z.abs())),
          f"{what}: z differs by {float(dz.max())}")
    dv = 0.0
    for f in ("up", "vp", "wp", "usig", "vsig", "wsig"):
        d = (getattr(pk, f) - getattr(pp, f)).abs()
        check(bool(torch.all(d <= K4_V_ATOL + K4_V_RTOL * getattr(pp, f).abs())),
              f"{what}: {f} differs by {float(d.max())}")
        dv = max(dv, float(d.max()))
    check(torch.equal(pk.itra, pp.itra), f"{what}: itra differs")
    flags = {f: int((getattr(pk, f) != getattr(pp, f)).sum())
             for f in ("cbt", "active")}
    for f, c in flags.items():
        check(c <= K4_FLAG_SHARE * n, f"{what}: {f} differs for {c} of {n}")
    return dict(max_dx=dx, max_dy=dy, max_dz=float(dz.max()), max_dv=dv,
                cbt_differ=flags["cbt"], active_differ=flags["active"])


def check_same_bits(pa, pb, what: str, fields=None) -> None:
    """Bitwise equality of the named particle fields (default: the fields
    the advance writes)."""
    import torch
    from flexpart_tpu_torch.core.advance import OUT_FIELDS
    for f in fields or OUT_FIELDS:
        a, b = getattr(pa, f), getattr(pb, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"{what}: {f} differs in "
              f"{int((a != b).sum())} particles")


def sample_met(p, height, tables, cfg):
    """(h, tropop, ust, wst, ol, wind) at the particles, plain version."""
    from flexpart_tpu_torch.core import interp
    hw = interp.horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, dz1 = interp.vert_weights(p.z, height)
    return interp.sample_all_quad(tables, hw, indz, dz1, p.x, p.y,
                                  cfg.nx, cfg.ny)


# the branches of the advance that a comparison must have entered
K4_BRANCHES = ("fresh", "pbl", "neutral", "unstable", "stable",
               "unstable_zeta_lt_0.03", "unstable_zeta_lt_0.4",
               "unstable_zeta_lt_0.96", "unstable_zeta_ge_0.96",
               "tlw_z_lt_ol", "tlw_zeta_lt_0.1", "tlw_else", "reflected",
               "troposphere", "transition", "stratosphere", "unscheduled",
               "date_line_wrapped", "pole_mirrored")


def branch_counts(p, p_out, height, tables, cfg, itime: int) -> dict:
    """How many scheduled particles of ``p`` enter each branch of the
    advance, from the plain version's own predicates; ``p_out`` is the
    plain version's result (``reflected``: a boundary-layer particle whose
    last substep bounced off the ground or the mixing height;
    ``pole_mirrored``: x moved by half the globe; ``exited``, a handful of
    particles at most on a global grid, is reported and not required)."""
    import torch
    from flexpart_tpu_torch.core import hanna
    h, tropop, _, _, ol, _ = sample_met(p, height, tables, cfg)
    on = p.active
    pbl = on & ((p.z / h) <= 1.0)
    free = on & ~pbl
    neutral, unstable, stable = hanna._regimes(h, hanna._small_ol(ol))
    zeta = torch.clamp(p.z / h, 0.0, 1.0)
    un = pbl & unstable
    nxm = float(cfg.nx - 1)
    kept = on & p_out.active
    jump = (p_out.x - p.x).abs()
    cyclic = torch.minimum(jump, nxm - jump)
    masks = {
        "fresh": on & ((p.itramem == itime) | (itime == 0)),
        "pbl": pbl, "neutral": pbl & neutral, "unstable": un,
        "stable": pbl & stable,
        "unstable_zeta_lt_0.03": un & (zeta < 0.03),
        "unstable_zeta_lt_0.4": un & (zeta >= 0.03) & (zeta < 0.4),
        "unstable_zeta_lt_0.96": un & (zeta >= 0.4) & (zeta < 0.96),
        "unstable_zeta_ge_0.96": un & (zeta >= 0.96),
        "tlw_z_lt_ol": un & (p.z < ol.abs()),
        "tlw_zeta_lt_0.1": un & (p.z >= ol.abs()) & (zeta < 0.1),
        "tlw_else": un & (p.z >= ol.abs()) & (zeta >= 0.1),
        "reflected": pbl & (p_out.cbt == -1),
        "troposphere": free & (p.z < tropop),
        "transition": free & (p.z >= tropop) & (p.z < tropop + 1000.0),
        "stratosphere": free & (p.z >= tropop + 1000.0),
        "unscheduled": ~on,
        "date_line_wrapped": kept & (jump > 0.75 * nxm),
        "pole_mirrored": kept & (cyclic > 0.25 * nxm),
        "exited": on & ~p_out.active,
    }
    return {k: int(v.sum()) for k, v in masks.items()}


def unique_rows(p, height, cfg) -> int:
    """Table rows that the particles' cells name (each needs reading once)."""
    import torch
    from flexpart_tpu_torch.core import interp
    hw = interp.horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, _ = interp.vert_weights(p.z, height)
    rows = interp._cell_rowid(hw, indz, cfg.nx, cfg.ny)[p.active]
    return int(torch.unique(rows).numel())


def step_setup(grid, **cfg_kw):
    from flexpart_tpu_torch.config import OutGrid
    from flexpart_tpu_torch.core.advance import StepConfig, StepParams
    from flexpart_tpu_torch.grid.conccalc import ConcConfig
    from flexpart_tpu_torch.grid.outgrid import OutputGridGeometry
    kw = {**K4_CASES["stock"], **cfg_kw}
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                     ldirect=1, method=0, **kw)
    prm = StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                          dxconst=grid.dxconst, dyconst=grid.dyconst,
                          lsynctime=LSYNC, fine=1.0 / kw["ifine"])
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
    t_start = time.perf_counter()
    from flexpart_tpu_torch.core import interp, reorder, rng
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
    for r in (1, 2, 3, 5):        # the last Philox call of a column, cut short
        check(torch.equal(rng.normals_cuda(r, 4096, k0, k1, off, device),
                          zk[:r, :4096]), f"K1 ({r}, n) is not rows 0-{r - 1}")

    def kernel():
        return rng.normals_cuda(rows, cols, k0, k1, off, device)

    def library():
        return torch.randn(K1_SHAPE, device=device).clamp_(-3.0, 3.0)

    ms = cuda_graph_ms(kernel)
    library_ms = cuda_graph_ms(library)
    plain_ms = cuda_ms(lambda: rng.normals_plain(rows, cols, k0, k1, off,
                                                 device), 5)
    res["normals"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, mean=mean, std=std,
                          ms_with_launch=cuda_ms(kernel, 50),
                          library_ms_with_launch=cuda_ms(library, 50),
                          **bound(4 * rows * cols,
                                  K1_OPS_PER_DRAW * rows * cols))

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
                                         64 if name == "rows" else 32),
                  f"K2 {name} shape {x.shape}")
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
    # 5 wind fields and 5 surface fields of two times in, the bf16 tables
    # out: 64 lanes of rows and 32 of rowsE per cell
    n_rows = (grid.nlev - 1) * grid.ny * grid.nx
    k2_in = 2 * 4 * (5 * grid.nlev + 5) * grid.ny * grid.nx
    res["quad_tables"] = dict(max_abs_err=k2_err, ms=times[torch.bfloat16][0],
                              plain_ms=times[torch.bfloat16][1],
                              library_ms=None,
                              f32_ms=times[torch.float32][0],
                              f32_plain_ms=times[torch.float32][1],
                              **bound(k2_in + 2 * (64 + 32) * n_rows,
                                      K2_OPS_PER_LANE * (64 + 32) * n_rows))
    height = z0.height
    del z0, z1

    # K3: sampling of 10 x 2**20 particles: both paths, on an unordered and
    # on a cell-ordered ensemble, all particles old enough for the 4-point
    # kernel and half of them.  Float atomics, now after per-warp sums,
    # order the additions differently in every run: hence a relative
    # tolerance.
    cfg, _, og, geo, ccfg = step_setup(grid)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    gk = zero_accumulators(geo, 1, 1, device=device).gridunc
    gp = torch.zeros_like(gk)
    grid_rows = gk.numel()
    warp = torch.arange(N_MAIN, device=device) // cc.K3_GROUP
    worst = 0.0
    k3 = {}
    for old in (1.0, 0.5):
        p = bench_particles(N_MAIN, device, seed=7, old_fraction=old)
        p = p.replace(itra=torch.full_like(p.itra, 14400),
                      itramem=p.itramem + 14400 - 3600)
        for order in ("unordered", "ordered"):
            if order == "ordered":
                p = reorder.reorder_by_cell_cuda(p, height, cfg)[0]
            for kp in (False, True):
                c = ccfg.replace(kernel_possible=kp)
                args = (p, 14400, lage, oh, 1.0, None, c)
                what = (f"K3 {'4-point' if kp else 'single-index'} path, "
                        f"{order}, {old} old")
                gk.zero_()
                gp.zero_()
                cc.conccalc_cuda(gk.view(-1, 1), *args)
                cc.conccalc_plain(gp.view(-1, 1), *args)
                d = (gk - gp).abs()
                worst = max(worst, float(d.max()))
                check(bool(torch.all(d <= K3_RTOL * gp.abs())),
                      f"{what} exceeds rtol {K3_RTOL}: max rel "
                      f"{float((d / gp.abs().clamp(min=1e-30)).max())}")
                check(abs(float(gk.sum()) - float(gp.sum()))
                      <= 1e-5 * float(gp.sum()), f"{what}: total differs")
                # the global atomics: one per pair without the per-warp
                # sums, one per distinct (warp, target) with them
                lin, valid, contrib = cc.conccalc_pairs(grid_rows, *args)
                pairs = (warp[:, None] * grid_rows + lin)[valid]
                case = dict(
                    pairs=int(pairs.numel()),
                    warp_target_pairs=int(torch.unique(pairs).numel()))
                # the library call: index_add_ of the kernel's own valid
                # pairs, made outside the timed region (the scatter half)
                lin_v, con_v = lin[valid], contrib[valid]
                del lin, valid, contrib, pairs
                flat_l = torch.zeros_like(gk.view(-1, 1))
                case["library_ms"] = cuda_ms(
                    lambda: flat_l.index_add_(0, lin_v, con_v), 10)
                del lin_v, con_v, flat_l
                check(0 < case["warp_target_pairs"] <= case["pairs"],
                      f"{what}: {case} pairs")
                case.update(
                    ms=cuda_ms(lambda: cc.conccalc_cuda(gk.view(-1, 1), *args),
                               10),
                    plain_ms=cuda_ms(lambda: cc.conccalc_plain(
                        gp.view(-1, 1), *args), 3))
                k3[f"{'kernel' if kp else 'single'}_{order}_"
                   f"{'all' if old == 1.0 else 'half'}_old"] = case
    # the main path's steady step: the 4-point path on ordered, old particles.
    # 41 B of particle state in, the grid read and written once (atomics
    # on top are not counted)
    steady = k3["kernel_ordered_all_old"]
    res["conccalc"] = dict(max_abs_err=worst, ms=steady["ms"],
                           plain_ms=steady["plain_ms"],
                           library_ms=steady["library_ms"], cases=k3,
                           **bound(41 * N_MAIN + 2 * 4 * gk.numel(),
                                   K3_OPS_PER_PARTICLE * N_MAIN))
    del p, gk, gp, warp
    torch.cuda.empty_cache()
    # host seconds of each part of the phase
    seconds = {"normals_quad_tables_conccalc": time.perf_counter() - t_start}

    def part(name, fn):
        t0 = time.perf_counter()
        out = fn(device, grid)
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    res["advance"] = part("advance", kernel_advance)
    res["reorder"] = part("reorder", kernel_reorder)
    res["advance"]["polar"] = part("advance_polar", kernel_advance_polar)
    res["advance"]["settling"] = part("advance_settling",
                                      kernel_advance_settling)
    res["advance_adaptive"] = part("advance_adaptive",
                                   kernel_advance_adaptive)
    res["advance_adaptive"]["cbl"] = part("advance_adaptive_cbl",
                                          kernel_advance_cbl)
    res["advance"]["nests"] = part("advance_nests", kernel_advance_nests)
    res["convection"], res["redist"], res["redist.backward"] = part(
        "convection_redist", kernel_convection)
    res.update(part("deposition", kernel_deposition))
    # the instantiations of a backward run (ldirect = -1)
    back = part("advance_backward", kernel_advance_backward)
    res["advance"]["backward"] = {k: back[f"advance_{k}"]
                                  for k in ("stock", "polar")}
    res["advance_adaptive"]["backward"] = {k: back[k] for k in (
        "adaptive", "adaptive_cbl")}
    res.update(part("conccalc_backward", kernel_conccalc_backward))
    res.update(part("bkdep", kernel_bkdep))
    res.update(part("clwc", kernel_clwc))
    res["seconds_by_part"] = seconds
    return res


def kernel_advance(device, grid) -> dict:
    """K4 against the plain advance on the card: three configurations at
    one 2**19 chunk of edge_particles with injected draws, each required
    to enter every branch of the advance; then the main path's
    configuration at the main path's shape, each side making its own draws
    from the same key (K4 in registers, the plain version through the
    normals kernel).  K4's time is taken on the ensemble in cell order, as
    the main path keeps it, and also on the unordered ensemble, on
    injected draws, on the same particles sorted by height and on none
    scheduled (a plain copy)."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 4)
    nxm = float(grid.nx - 1)

    def setup(**kw):
        cfg, prm, *_ = step_setup(grid, **kw)
        tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(z0, z1, *tw,
                                               dtype=cfg.table_dtype)
        a = advance.advance_args(cfg, prm, itime, 0, mem1)

        def runs(p, draws, offset):
            args = (p, z0.height, tables, a, key, cfg)
            return (lambda: advance.advance_all_cuda(*args, draws, offset),
                    lambda: advance.advance_all_plain(*args, draws, offset),
                    lambda: advance.advance_all_cuda(*args, None, offset))
        return cfg, tables, runs

    def make_draws(cfg, n, offset):
        return {tag: rng.normals(key, (rows, n), tag, offset, device=device)
                for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}

    res = {"cases": {}}
    offset = 5 * CHUNK
    for name, kw in K4_CASES.items():
        cfg, tables, runs = setup(**kw)
        p = edge_particles(CHUNK, device, 21, itime, lambda q: sample_met(
            q, z0.height, tables, cfg)[0])
        draws = make_draws(cfg, CHUNK, offset)
        kernel, plain, in_registers = runs(p, draws, offset)
        (pk, dk), (pp, dp) = kernel(), plain()
        torch.cuda.synchronize()
        case = compare_particles(pk, pp, f"K4 {name}", nxm)
        for f in ("n_active", "n_exited"):
            check(abs(int(getattr(dk, f)) - int(getattr(dp, f)))
                  <= K4_FLAG_SHARE * CHUNK, f"K4 {name}: {f} differs")
        check_same_bits(in_registers()[0], pk,
                        f"K4 {name}: draws in registers vs injected")
        branches = branch_counts(p, pp, z0.height, tables, cfg, itime)
        for b in K4_BRANCHES:
            check(branches[b] > 0,
                  f"K4 {name}: no test particle enters branch {b}")
        case.update(n_active=int(dk.n_active), n_exited=int(dk.n_exited),
                    branches=branches,
                    ms=cuda_ms(in_registers, 20), plain_ms=cuda_ms(plain, 3))
        res["cases"][name] = case
        del p, draws, pk, pp, kernel, plain, in_registers, runs, tables
        torch.cuda.empty_cache()

    cfg, tables, runs = setup()
    p = bench_particles(N_MAIN, device, seed=3, old_fraction=1.0)  # steady
    _, plain, in_registers = runs(p, None, 0)
    (pk, _), (pp, _) = in_registers(), plain()
    torch.cuda.synchronize()
    full = compare_particles(pk, pp, "K4 at the main path's shape", nxm)
    # 54 B of state in, 50 B out, each table row that a particle's cell
    # names read once (128 B of the start table, 48 B of the end table)
    row_b = 128 if cfg.met_bf16 else 256
    rows0 = unique_rows(p, z0.height, cfg)
    rows1 = unique_rows(pk, z0.height, cfg)
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    res.update(full, n=N_MAIN, unique_rows=rows0, unique_rows_end=rows1,
               max_abs_err=max(full["max_dx"], full["max_dy"]),
               branches=branch_counts(p, pp, z0.height, tables, cfg, itime),
               ms=cuda_ms(runs(ordered, None, 0)[2], 10),
               unordered_ms=cuda_ms(in_registers, 10),
               plain_ms=cuda_ms(plain, 2),
               library_ms=None,
               **bound(104 * N_MAIN + row_b * rows0 + row_b * 3 // 8 * rows1,
                       K4_OPS_PER_PARTICLE * N_MAIN))
    del pk, pp, plain, ordered
    # where K4's time goes on the unordered ensemble: the same launch
    # without the generator, with neighbouring threads gathering
    # neighbouring rows, and with no work
    res["injected_draws_ms"] = cuda_ms(
        runs(p, make_draws(cfg, N_MAIN, 0), 0)[0], 10)
    torch.cuda.empty_cache()
    res["sorted_by_z_ms"] = cuda_ms(
        runs(p.replace(z=torch.sort(p.z).values), None, 0)[2], 10)
    res["none_scheduled_ms"] = cuda_ms(
        runs(p.replace(active=torch.zeros_like(p.active)), None, 0)[2], 10)
    return res


def sphere_particles(n: int, device, seed: int, itime: int, nx: int,
                     ny: int):
    """bench_particles spread over the whole sphere: x in [0, nx - 1), y in
    [0, ny - 1], a quarter released at ``itime`` (fresh), the first
    2**16 within 0.15 degrees of a pole (half north, half south), a
    quarter of those within 0.01 degrees, so that some cross it within a
    step."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)

    def u(lo, hi, m=n):
        return torch.rand(m, generator=gen, device=device) * (hi - lo) + lo

    y = u(0.0, ny - 1.0)
    m = 2 ** 15
    y[:m] = u(ny - 1.15, ny - 1.0, m)
    y[m:2 * m] = u(0.0, 0.15, m)
    # a kilometre from the pole, where a step's turbulence carries across
    y[:m // 4] = u(ny - 1.01, ny - 1.0, m // 4)
    y[m:m + m // 4] = u(0.0, 0.01, m // 4)
    fresh = u(0.0, 1.0) < 0.25
    return p.replace(x_hi=u(0.0, nx - 1.0), y_hi=y,
                     itramem=torch.where(fresh, itime, itime - 7200)
                     .to(torch.int32),
                     itra=torch.full_like(p.itra, itime))


def kernel_advance_polar(device, grid) -> dict:
    """K4's POLAR instantiation against the plain advance on 10 x 2**20
    particles over the whole sphere, both caps included, with injected
    draws; with its draws made in registers against itself fed K1's,
    bitwise.  The particles in the north cap, in the south cap and those
    that cross a pole within the step must be > 0.  Timed unordered and
    in cell order, beside the stock instantiation on the same particles."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 6)
    nxm = float(grid.nx - 1)
    cfg, prm, *_ = step_setup(grid, polar=True)
    stock = step_setup(grid)[0]
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    a_stock = advance.advance_args(stock, prm, itime, 0, mem1)
    check(a.polar == 1 and a_stock.polar == 0, "K4 polar: polar flags")
    p = sphere_particles(N_MAIN, device, 31, itime, grid.nx, grid.ny)
    draws = {tag: rng.normals(key, (rows, N_MAIN), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}

    def run(q, d, args=a, c=cfg):
        return advance.advance_all_cuda(q, z0.height, tables, args, key, c,
                                        d, 0)

    (pk, dk) = run(p, draws)
    (pp, dp) = advance.advance_all_plain(p, z0.height, tables, a, key, cfg,
                                         draws, 0)
    torch.cuda.synchronize()
    res = compare_particles(pk, pp, "K4 POLAR", nxm)
    for f in ("n_active", "n_exited"):
        check(abs(int(getattr(dk, f)) - int(getattr(dp, f)))
              <= K4_FLAG_SHARE * N_MAIN, f"K4 POLAR: {f} differs")
    check_same_bits(run(p, None)[0], pk,
                    "K4 POLAR: draws in registers vs injected")
    bitwise = all(torch.equal(getattr(pk, f), getattr(pp, f))
                  for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z"))
    lat = grid.ylat0 + p.y * grid.dy
    north, south = p.active & (lat > 75.0), p.active & (lat < -75.0)
    jump = (pp.x - p.x).abs()
    crossed = (north | south) & pp.active & (torch.minimum(jump, nxm - jump)
                                             > 0.25 * nxm)
    counts = dict(north_cap=int(north.sum()), south_cap=int(south.sum()),
                  pole_crossings=int(crossed.sum()),
                  exited=int((p.active & ~pp.active).sum()))
    for b in ("north_cap", "south_cap", "pole_crossings"):
        check(counts[b] > 0, f"K4 POLAR: no test particle enters {b}")
    n_cap = counts["north_cap"] + counts["south_cap"]
    row_b = 128 if cfg.met_bf16 else 256
    rows0 = unique_rows(p, z0.height, cfg)
    rows1 = unique_rows(pk, z0.height, cfg)
    del pk, pp, draws
    torch.cuda.empty_cache()
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    res.update(
        bitwise=bitwise, branches=counts, n=N_MAIN, library_ms=None,
        max_abs_err=max(res["max_dx"], res["max_dy"]),
        ms=cuda_ms(lambda: run(ordered, None), 10),
        unordered_ms=cuda_ms(lambda: run(p, None), 10),
        stock_ms_same_particles=cuda_ms(
            lambda: run(ordered, None, a_stock, stock), 10),
        plain_ms=cuda_ms(lambda: advance.advance_all_plain(
            p, z0.height, tables, a, key, cfg, None, 0), 2),
        **bound(104 * N_MAIN + row_b * rows0 + row_b * 3 // 8 * rows1,
                K4_OPS_PER_PARTICLE * N_MAIN + K4_POLAR_OPS * n_cap))
    return res


def aerosol_species():
    """The settling species of the sim_adaptive phase and the advance's
    settling cases: the default tracer and a Cs-137-like aerosol with a
    density (2500 kg/m3, 10 um: about 7 mm/s), which rain, snow, CCN and IN
    scavenge, a constant dry velocity of 1 mm/s and Cs-137's half-life."""
    from flexpart_tpu_torch.config import Species
    return (Species(),
            Species(name="CS-137", decay_halflife=30.17 * 365.25 * 86400.0,
                    crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                    in_aero=0.1, density=2500.0, dquer=10.0, dsigma=1.25,
                    dryvel=1.0e-3))


def settling_params(grid, **cfg_kw):
    """(cfg, prm) of an advance with aerosol_species' settling parameters,
    as the Simulation fills them."""
    from flexpart_tpu_torch.core.advance import StepConfig, StepParams
    sp = aerosol_species()
    scs = [s.size_classes() for s in sp]
    kw = {**K4_CASES["stock"], "method": 0, **cfg_kw}
    cfg = StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                     ldirect=1, **kw)
    prm = StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0 / cfg.ifine,
        ctl=5.0 if cfg.method == 1 else -5.0,
        sp_density=[max(s.density, -1.0) for s in sp],
        sp_dquer=[s.dquer for s in sp],
        sp_cunningham=[c.cunningham if c else 0.0 for c in scs],
        sp_vsetaver=[c.vsetaver if c else 0.0 for c in scs])
    return cfg, prm


def with_species(p, device, seed: int, aerosol_share: float):
    """p carrying two species, one per particle: the aerosol (species 1)
    for ``aerosol_share`` of them, the tracer for the rest."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = p.capacity
    aero = torch.rand(n, generator=gen, device=device) < aerosol_share
    m = torch.zeros((n, 2), dtype=torch.float32, device=device)
    m[:, 0] = torch.where(aero, 0.0, 1.0 / n)
    m[:, 1] = torch.where(aero, 1.0 / n, 0.0)
    return p.replace(mass=m, mass0=m.clone())


def differing_particles(pk, pp, fields) -> int:
    """Particles with a field whose bits differ between two results."""
    import torch
    bad = torch.zeros(pk.capacity, dtype=torch.bool, device=pk.x_hi.device)
    for f in fields:
        a, b = getattr(pk, f), getattr(pp, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        bad |= a != b
    return int(bad.sum())


def settle_cells(p, height, cfg) -> int:
    """(level, column) cells whose two levels of temperature and density
    settling reads: the start level and column of every particle."""
    import torch
    from flexpart_tpu_torch.core import interp
    nix = torch.clamp(torch.round(p.x).to(torch.int32), 0, cfg.nx - 1).long()
    njy = torch.clamp(torch.round(p.y).to(torch.int32), 0, cfg.ny - 1).long()
    indz, _ = interp.vert_weights(p.z, height)
    key = (indz.long() * cfg.ny + njy) * cfg.nx + nix
    return int(torch.unique(key[p.active]).numel())


def kernel_advance_settling(device, grid) -> dict:
    """K4's SETTLING instantiation beside the stock one on the same 10 x
    2**20 particles (steady, bench.py's start, a third of them the
    aerosol), each making its draws in registers: against the plain
    advance with the same key, bitwise (the differing particles counted);
    its time in cell order and as drawn, the stock K4's on the same
    particles, and its bound: K4's bytes, mass0, and the two levels of
    temperature and density of each cell it reads; K4's operations and, per
    aerosol particle, settling's instructions in the compiled kernel
    (settling_instructions) over the instruction rate."""
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 8)
    cfg, prm = settling_params(grid, settling=True, polar=True)
    stock = settling_params(grid, polar=True)[0]
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    a_stock = advance.advance_args(stock, prm, itime, 0, mem1)
    settle = advance.settle_met(z0, cfg)
    check(a.settling == 1 and a_stock.settling == 0, "K4 settling: flags")
    p = with_species(bench_particles(N_MAIN, device, seed=5,
                                     old_fraction=1.0), device, 6, 1.0 / 3)

    def run(q, args=a, c=cfg, s=settle):
        return advance.advance_all_cuda(q, z0.height, tables, args, key, c,
                                        None, 0, s)

    (pk, _), (pp, _) = run(p), advance.advance_all_plain(
        p, z0.height, tables, a, key, cfg, None, 0, settle)
    torch.cuda.synchronize()
    res = compare_particles(pk, pp, "K4 SETTLING", float(grid.nx - 1))
    differ = differing_particles(pk, pp, advance.OUT_FIELDS)
    check(differ == 0, f"K4 SETTLING differs from its plain version in "
          f"{differ} particles")
    ps = run(p, a_stock, stock, None)[0]
    aero = p.mass0[:, 1] > 0.0
    # settling only moves the aerosol: the tracer's particles are the stock
    # instantiation's, bitwise
    moved = float((ps.z - pk.z)[aero & pk.active].mean())
    check(torch.equal(pk.z[~aero], ps.z[~aero]),
          "K4 SETTLING: the tracer's particles differ from the stock K4's")
    check(moved > 0.0, f"K4 SETTLING: the aerosol does not sink ({moved})")
    cells = settle_cells(p, z0.height, cfg)
    row_b = 128 if cfg.met_bf16 else 256
    rows0 = unique_rows(p, z0.height, cfg)
    rows1 = unique_rows(pk, z0.height, cfg)
    n_aero = int((aero & p.active).sum())
    ins = settling_instructions(_build.ADVANCE, cfg.met_bf16, cfg.polar)
    del pk, pp, ps
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    res.update(
        n=N_MAIN, aerosol_particles=n_aero, differing_particles=differ,
        settling_instructions=ins,
        bitwise=differ == 0, max_abs_err=max(res["max_dx"], res["max_dy"]),
        aerosol_mean_drop_against_stock_m=moved, settle_cells=cells,
        ms=cuda_ms(lambda: run(ordered), 10),
        unordered_ms=cuda_ms(lambda: run(p), 10),
        stock_ms_same_particles=cuda_ms(
            lambda: run(ordered, a_stock, stock, None), 10),
        plain_ms=cuda_ms(lambda: advance.advance_all_plain(
            p, z0.height, tables, a, key, cfg, None, 0, settle), 2),
        library_ms=None,
        **bound(104 * N_MAIN + 8 * N_MAIN + row_b * rows0
                + row_b * 3 // 8 * rows1 + 16 * cells,
                K4_OPS_PER_PARTICLE * N_MAIN,
                ins["per_particle"] * n_aero))
    return res


def boundary_layer_particles(n: int, device, seed: int, grid, itime: int,
                             hmix_at):
    """bench_particles spread over the whole sphere and put in the boundary
    layer: seven in eight below the local mixing height ``hmix_at``, the
    rest up to 3 km above it; a quarter released at ``itime`` (fresh), the
    others with an adaptive step of 0-300 s from an earlier step and
    velocities of earlier steps; a third the aerosol of aerosol_species."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 5)

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    p = p.replace(x_hi=u(0.0, grid.nx - 1.0), y_hi=u(0.0, grid.ny - 1.0))
    h = hmix_at(p)
    below = u(0.0, 1.0) < 7.0 / 8.0
    fresh = u(0.0, 1.0) < 0.25
    p = p.replace(
        z=torch.where(below, u(0.0, 1.0) * h, h + u(0.0, 3000.0)),
        itramem=torch.where(fresh, itime, itime - 7200).to(torch.int32),
        itra=torch.full_like(p.itra, itime),
        idt=u(0.0, 300.0).to(torch.int32),
        up=u(-1.0, 1.0), vp=u(-1.0, 1.0), wp=u(-1.0, 1.0),
        usig=u(-0.3, 0.3), vsig=u(-0.3, 0.3), wsig=u(-0.01, 0.01))
    return with_species(p, device, seed + 6, 1.0 / 3)


def warp_efficiency(passes) -> dict:
    """How the lanes of warps of 32 consecutive particles, one thread each,
    would share their passes (K11 without its pool): ``warp_efficiency``,
    over warps with a pass, the mean of (mean passes / max passes of its
    lanes, zero-pass lanes included); ``warp_efficiency_pooled``, the
    passes over the lane iterations such warps issue (32 x each warp's max,
    a last partial warp as a full one), pooled as K11's lane_efficiency
    is; the passes per particle that takes any (mean, p99, max)."""
    import torch
    n = passes.numel() // 32 * 32
    w = passes[:n].reshape(-1, 32).float()
    mx = w.max(dim=1).values
    some = mx > 0
    eff = float((w.mean(dim=1)[some] / mx[some]).mean()) if some.any() \
        else 0.0
    issued = 32 * (int(mx.sum()) + (int(passes[n:].max())
                                    if passes.numel() > n else 0))
    total = int(passes.sum(dtype=torch.int64))
    took = passes[passes > 0].float()
    q = float(torch.quantile(took[:2 ** 24], 0.99)) if took.numel() else 0.0
    return dict(warp_efficiency=eff,
                warp_efficiency_pooled=total / issued if issued else 0.0,
                warp_lane_iterations=issued,
                particles_in_the_loop=int(took.numel()),
                passes_mean=float(took.mean()) if took.numel() else 0.0,
                passes_p99=q, passes_max=int(passes.max()),
                passes_total=total)


_SASS_FUNCTIONS = {}


def sass_functions(sass: str) -> dict:
    """cuobjdump -sass text split by function: {mangled name: its lines},
    split once per text in a run."""
    import re
    if sass not in _SASS_FUNCTIONS:
        funcs, cur = {}, None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\S+)", ln)
            if m:
                cur = m.group(1)
                funcs[cur] = []
                continue
            if cur is not None:
                funcs[cur].append(ln)
        _SASS_FUNCTIONS[sass] = funcs
    return _SASS_FUNCTIONS[sass]


def sass_instantiation(kernel, template: str, flags) -> tuple:
    """The SASS of the one instantiation of the kernel template
    ``template`` in ``kernel``'s library whose template arguments are
    ``flags`` (as in ptxas_by_entry; a bool argument is a Python bool, an
    int one a Python int): its name and its instructions as
    (address, opcode, conditional: predicated, a BRA.DIV or a branch on a
    predicate operand; branch target or None; operands), labels
    resolved."""
    import re
    want = "".join(f"Lb{int(f)}E" if isinstance(f, bool) else f"Li{f}E"
                   for f in flags)
    funcs = sass_functions(kernel.cuobjdump("-sass"))
    hit = [f for f in funcs if re.search(r"\d%sI%sE" % (template, want), f)]
    check(len(hit) == 1, f"{kernel.name}: instantiation {want} of "
          f"{template} not found once in {sorted(funcs)}")
    code, labels, pending = [], {}, []
    for ln in funcs[hit[0]]:
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9._]*)(.*)", ln)
        if not m:
            continue
        addr, pred, op, rest = (int(m.group(1), 16), m.group(2), m.group(3),
                                m.group(4))
        for lab in pending:
            labels[lab] = addr
        pending = []
        target = None
        cond = bool(pred) and pred.strip() != "@PT"
        operands = rest.split(";")[0].strip()
        if op.startswith("BRA"):
            # BRA.DIV (taken when the warp is diverged) and a branch on a
            # predicate operand fall through as well
            cond = cond or ".DIV" in op or bool(
                re.match(r"!?U?P[0-6]\b", operands))
            lab = re.search(r"\((\.L_x_\d+)\)", operands)
            hexes = re.findall(r"0x([0-9a-f]+)", operands)
            target = lab.group(1) if lab else (int(hexes[-1], 16) if hexes
                                               else None)
        code.append((addr, op, cond, target, operands))
    code = [(a, op, c, labels.get(t, t) if isinstance(t, str) else t, o)
            for a, op, c, t, o in code]
    return hit[0], code


def sass_path(code, lo: int, hi: int, pick=min, free=frozenset()) -> int:
    """Instructions (NOPs and the addresses in ``free`` aside) on the
    cheapest (``pick`` min) or dearest (max) path from the instruction at
    address ``lo`` to the one at ``hi``, both counted, along the forward
    edges between them: a branch goes to its target and, predicated, on to
    the next instruction; an unpredicated EXIT, RET or branch ends or
    leaves the straight line.  A loop inside the range is passed once (its
    back edge is not an edge here); a call counts as one instruction."""
    best = {lo: 0}
    for k, (addr, op, cond, target, _) in enumerate(code):
        if addr < lo or addr not in best:
            continue
        c = best[addr] + (op != "NOP" and addr not in free)
        if addr == hi:
            return c
        nxt = code[k + 1][0] if k + 1 < len(code) else None
        succ = []
        if op.startswith("BRA"):
            if target is not None and addr < target <= hi:
                succ.append(target)
            if cond:
                succ.append(nxt)
        elif op.startswith(("EXIT", "RET", "BPT")):
            if cond:
                succ.append(nxt)
        else:
            succ.append(nxt)
        for t in succ:
            if t is not None and t <= hi:
                best[t] = pick(best[t], c) if t in best else c
    raise AssertionError(f"no path from {lo:#x} to {hi:#x}")


# K11's pool: a row of THREADS 32-bit words for each field of a particle
K11_POOL_ROW_BYTES = 256 * 4


def k11_pool_traffic(code, lo: int, hi: int) -> dict:
    """The instructions in [lo, hi] of K11's compiled pass body that move a
    particle between the block's pool and the registers, which the design
    adds and a pass's own work does not need: the load of ``order[t]`` and
    the store of ``in_loop[p]`` (the shared loads and stores narrower than a
    word: the pass's own shared loads are float heights), and the loads and
    stores whose address register derives from ``order[t]``, i.e. from the
    slot p.  Derivation is followed in address order: a register an
    arithmetic instruction writes derives from p if one of its sources does
    (a predicated write keeps what the register held); what a load
    returns does not.  Returns their addresses and the pool words (the
    offsets / K11_POOL_ROW_BYTES) stored and loaded; every such access must
    sit on a row boundary."""
    import re

    def regs(text):
        return {int(r) for r in re.findall(r"\bR(\d+)\b", text)}

    def widths(op):
        return 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) \
            else 1

    from_slot, traffic, stored, loaded = set(), set(), set(), set()
    spilled = set()         # stack slots that hold a register derived from p
    for addr, op, cond, _, operands in code:
        if not lo <= addr <= hi:
            continue
        if op.startswith(("STL", "LDL")):
            # a spill of a derived register, and its reload, stay derived
            m = re.search(r"\[R1(?:\+(0x[0-9a-f]+))?\]", operands)
            off = int(m.group(1), 16) if m and m.group(1) else 0
            if op.startswith("STL"):
                src = regs(operands.split("]", 1)[-1])
                if src & from_slot:
                    spilled.add(off)
                elif not cond:
                    spilled.discard(off)
                continue
            dest = re.fullmatch(r"R(\d+)(?:\.64)?",
                                operands.split(",")[0].strip())
            if dest is not None:
                written = set(range(int(dest.group(1)),
                                    int(dest.group(1)) + widths(op)))
                if off in spilled:
                    from_slot |= written
                elif not cond:
                    from_slot -= written
            continue
        shared = op.startswith(("LDS", "STS"))
        if shared and re.search(r"\.(U|S)(8|16)\b", op):
            traffic.add(addr)
            if op.startswith("LDS"):
                dest = min(regs(operands.split(",")[0]), default=None)
                if dest is not None:
                    from_slot.add(dest)
            continue
        if shared:
            m = re.search(r"\[R(\d+)(?:\+(-?0x[0-9a-f]+))?\]", operands)
            if m and int(m.group(1)) in from_slot:
                off = int(m.group(2), 16) if m.group(2) else 0
                check(off % K11_POOL_ROW_BYTES == 0, f"K11: a pool access "
                      f"at {addr:#x} off a row: {op} {operands}")
                traffic.add(addr)
                (stored if op.startswith("STS") else loaded).add(
                    off // K11_POOL_ROW_BYTES)
            if op.startswith("STS"):
                continue
        parts = operands.split(",", 1)
        dest = re.fullmatch(r"R(\d+)(?:\.64)?", parts[0].strip())
        if dest is None:
            continue
        written = set(range(int(dest.group(1)),
                            int(dest.group(1)) + widths(op)))
        derived = not shared and bool(
            regs(parts[1] if len(parts) > 1 else "") & from_slot)
        if derived:
            from_slot |= written
        elif not cond:
            from_slot -= written
    return dict(addresses=traffic, stored=sorted(stored),
                loaded=sorted(loaded))


def k11_blocks(kernel) -> dict:
    """K11's block shape as its source declares it: THREADS threads a
    block, MIN_BLOCKS blocks an SM must hold of a stock instantiation and
    MIN_BLOCKS_CBL of a CBL one (its launch bound)."""
    import re
    text = kernel.source.read_text()
    return {n: int(re.search(r"constexpr int %s = (\d+);" % n, text)[1])
            for n in ("THREADS", "MIN_BLOCKS", "MIN_BLOCKS_CBL")}


def k11_cbl_layout(kernel) -> dict:
    """K11 CBL's occupancy as built: blocks an SM must hold (k11_blocks'
    MIN_BLOCKS_CBL), the register cap that gives (65,536 a SM), its warps
    an SM, and each CBL instantiation's registers, stack and spills from
    ptxas, each within the cap."""
    shape = k11_blocks(kernel)
    blocks = shape["MIN_BLOCKS_CBL"]
    cap = 65536 // (shape["THREADS"] * blocks) // 8 * 8
    entries = {e: v for e, v in ptxas_by_entry(kernel.build_log).items()
               if e.startswith("advance_adaptive_kernel<")
               and e.split(",")[1] == "2"}
    check(bool(entries) and all(v["registers"] <= cap
                                for v in entries.values()),
          f"K11 CBL: registers over the cap {cap}: {entries}")
    return dict(min_blocks=blocks, register_cap=cap,
                warps_per_sm=blocks * shape["THREADS"] // 32,
                entries=entries)


def k11_entry(cfg) -> tuple:
    """The template arguments of K11's instantiation for ``cfg``: table
    type, turbulence (0 Hanna1, 1 TS, 2 CBL), polar, settling."""
    return (cfg.met_bf16, 2 if cfg.cblflag else int(cfg.turbswitch),
            cfg.polar, cfg.settling)


def local_memory(code, lo: int, hi: int) -> set:
    """The addresses in [lo, hi] of the stores and loads of local memory
    (STL, LDL): the registers the compiler spills to the thread's stack and
    reloads, and the frame a call saves."""
    return {a for a, op, _, _, _ in code
            if lo <= a <= hi and op.startswith(("STL", "LDL"))}


def k11_instructions(kernel, entry_flags, ifine: int) -> dict:
    """K11's instructions per pass, read from the compiled kernel: in the
    SASS of the instantiation a run takes (``entry_flags``: k11_entry's
    table type, turbulence, polar, settling), the loop of iterations is the widest backward branch of the
    kernel's body (up to its first unconditional EXIT; the compiler puts
    the slow paths of a vote after it), and the substep loop the widest
    loop inside it.  Before the substep loop lie the dealing of the
    particles still in the loop to the lanes (a ballot, the block's last
    barrier) and the branch that takes a thread past the count over the
    pass to the end of the iteration; the pass body runs from the
    instruction after that branch to the loop's back edge.  A pass is the cheapest path (``sass_path``: at each
    branch of the data, the Hanna regime, the OU form, the drag regime of
    settling, a gas, the draws a substep takes, the cheaper side) from
    there to the substep loop's head and on through the loop once (the
    last substep, whose Hanna refresh is skipped) to the back edge, plus
    the substep loop's cheapest body, Hanna's refresh included, ifine - 1
    times more.  Not counted as pass work: the dealing, a particle's start
    and end, and in the pass body the moves between the pool and the
    registers (k11_pool_traffic) and the stores and loads of local memory
    (the registers the compiler spills to the stack), which the design
    adds and a pass's own work does not need; both are reported beside
    it.  The dearest path is given too; the toolkit's slow paths are
    calls."""
    name, code = sass_instantiation(kernel, "advance_adaptive_kernel",
                                    entry_flags)
    body_end = min((a for a, op, cond, _, _ in code
                    if op.startswith("EXIT") and not cond),
                   default=code[-1][0])
    back = [(t, a) for a, op, _, t, _ in code
            if op.startswith("BRA") and t is not None and t < a <= body_end]
    check(bool(back), "K11: no loop found in the compiled kernel")
    outer = max(back, key=lambda b: b[1] - b[0])
    inside = [b for b in back if outer[0] <= b[0] and b[1] < outer[1]]
    check(bool(inside), "K11: no substep loop inside the loop of iterations")
    sub = max(inside, key=lambda b: b[1] - b[0])
    bars = [a for a, op, _, _, _ in code
            if op.startswith("BAR") and outer[0] <= a < sub[0]]
    check(bool(bars), "K11: no barrier before the pass body")
    check(any(outer[0] <= a < max(bars) and op.startswith("VOTE")
              for a, op, _, _, _ in code),
          "K11: no ballot deals the particles before the pass body")
    skip = [k for k, (a, op, cond, t, _) in enumerate(code)
            if max(bars) < a < sub[0] and op.startswith("BRA") and cond
            and ".DIV" not in op and t is not None
            and sub[1] < t <= outer[1]]
    check(bool(skip), "K11: no branch takes a thread past the pass body")
    first = code[skip[0] + 1][0]
    pool = k11_pool_traffic(code, first, outer[1])
    check(pool["stored"] == list(range(len(pool["stored"]))) and
          len(pool["stored"]) >= 1, f"K11: the pass stores pool words "
          f"{pool['stored']}, not the first ones")

    def count(lo, hi):
        return sum(1 for a, op, _, _, _ in code
                   if lo <= a <= hi and op != "NOP")

    local = local_memory(code, first, outer[1])

    out = {"entry": name[:80], "kernel": count(0, code[-1][0]),
           "iteration_loop": count(*outer),
           "dealing": count(outer[0], first - 1),
           "pass_body": count(first, outer[1]),
           "substep_loop": count(*sub),
           "pool_moves_in_pass_body": len(pool["addresses"]),
           "local_memory_in_pass_body": len(local),
           "pool_words_stored": len(pool["stored"]),
           "pool_words_loaded": len(pool["loaded"]),
           "calls_in_pass_body": sum(1 for a, op, _, _, _ in code
                                     if first <= a <= outer[1]
                                     and op.startswith("CALL"))}
    head = sum(1 for a, op, _, _, _ in code if a == sub[0] and op != "NOP")
    for tag, pick in (("cheapest", min), ("dearest", max)):
        for what, free in (("", pool["addresses"] | local),
                           ("_with_pool_moves", local)):
            once = (sass_path(code, first, sub[0], pick, free)
                    + sass_path(code, sub[0], outer[1], pick, free) - head)
            body = sass_path(code, *sub, pick, free)
            out[f"per_pass_{tag}{what}"] = once + (ifine - 1) * body
        out[f"substep_{tag}"] = body
    return out


def settling_instructions(kernel, bf16: bool, polar: bool) -> dict:
    """Settling's instructions in K4, read from the compiled kernel: those
    of the SETTLING instantiation beyond the stock one with the same table
    type and polar flag (turbswitch off), NOPs aside: the species search,
    the column's two levels of temperature and density, the viscosity and
    the drag loop, whose body counts once (it runs five times) with both
    sides of its branches."""
    n = {}
    for settle in (False, True):
        _, code = sass_instantiation(kernel, "advance_kernel",
                                     (bf16, False, polar, settle, False))
        n[settle] = sum(1 for _, op, _, _, _ in code if op != "NOP")
    return dict(stock=n[False], settling=n[True],
                per_particle=n[True] - n[False])


def k11_bound(p, pk, passes, height, cfg, a, instructions) -> dict:
    """K11's least time on these inputs.  Bytes: K4's state, idt and mass0
    read, K4's outputs, idt, t_below and the pass count written; each
    start row once (64 lanes, as K4), whose lanes 0-39 the first pass
    gathers again; per later pass k one row of 40 lanes for each distinct
    column of the particles still in the loop (its level may differ, so
    this is a floor); each end row of rowsE once (24 lanes) for the
    particles that take the corrector.  The free troposphere's and the final
    sample's rows lie in the particle's start column and are not charged.
    Operations: K4's (float32 operations) for each particle that takes no
    pass, whose step is K4's above the boundary layer, and per pass the
    cheapest path's instructions (k11_instructions) over the instruction rate;
    the start and the end of a particle that takes passes are not
    charged."""
    import torch
    from flexpart_tpu_torch.core import interp
    row_b = 2 if cfg.met_bf16 else 4
    n = p.capacity
    total = int(passes.sum(dtype=torch.int64))
    rows0 = unique_rows(p, height, cfg)
    hw = interp.horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    col = (hw.jy.long() * cfg.nx + hw.ix.long())
    later = sum(int(torch.unique(col[passes > k]).numel())
                for k in range(1, int(passes.max()) + 1))
    pett = pk.replace(active=pk.active & (pk.idt == LSYNC))
    rows_e = unique_rows(pett, height, cfg) if a.can_pett else 0
    per_pass = instructions["per_pass_cheapest"]
    no_pass = n - int((passes > 0).sum())
    n_bytes = (n * (58 + 4 * p.nspec + 62) + 64 * row_b * rows0
               + 40 * row_b * later + 24 * row_b * rows_e)
    return dict(instructions_per_pass=per_pass, later_pass_columns=later,
                **bound(n_bytes, K4_OPS_PER_PARTICLE * no_pass,
                        per_pass * total))


def check_adaptive(q, height, tables, a, key, cfg, settle, what: str,
                   offset: int = 0, time_plain: bool = False):
    """K11 against the plain advance on the card with the same key (K11's
    draws made in registers, the plain version's by K1, pass by pass):
    every output, idt included, t_below, the passes and the counts, bitwise;
    the K4 tolerances are held as well and the largest differences
    reported.  ``time_plain``: the plain run of the check is timed by CUDA
    events (``plain_ms``, one run without a warm-up), so that a slow plain
    version runs once."""
    import copy
    import torch
    from flexpart_tpu_torch.core import advance
    (pk, dk) = advance.advance_adaptive_cuda(q, height, tables, copy.copy(a),
                                             key, cfg, None, offset, settle)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    (pp, dp) = advance.advance_all_plain(q, height, tables, copy.copy(a), key,
                                         cfg, None, offset, settle)
    stop.record()
    torch.cuda.synchronize()
    res = compare_particles(pk, pp, f"{what}: K11", float(cfg.nx - 1))
    differ = differing_particles(pk, pp, advance.ADAPTIVE_OUT_FIELDS)
    check(differ == 0, f"{what}: K11 differs from its plain version in "
          f"{differ} particles (idt: "
          f"{int((pk.idt != pp.idt).sum())})")
    check(torch.equal(dk.passes, dp.passes), f"{what}: K11 passes differ in "
          f"{int((dk.passes != dp.passes).sum())} particles")
    check(torch.equal(dk.t_below.view(torch.int32),
                      dp.t_below.view(torch.int32)),
          f"{what}: K11 t_below differs")
    for f in ("n_active", "n_exited", "nan_count"):
        check(int(getattr(dk, f)) == int(getattr(dp, f)),
              f"{what}: K11 {f} differs")
    executed, issued = (int(v) for v in dk.lane_work[:2])
    check(executed == int(dk.passes.sum(dtype=torch.int64)),
          f"{what}: K11 counted {executed} passes, its particles "
          f"{int(dk.passes.sum(dtype=torch.int64))}")
    res.update(differing_particles=differ, bitwise=differ == 0,
               max_abs_err=max(res["max_dx"], res["max_dy"]),
               n_active=int(dk.n_active), **warp_efficiency(dk.passes),
               **lane_efficiency(dk.lane_work))
    if time_plain:
        res["plain_ms"] = start.elapsed_time(stop)
    return res, pk, dk


def lane_efficiency(lane_work) -> dict:
    """K11's refilled lanes: the passes it executed over the lane
    iterations it issued (32 per warp iteration that ran a pass)."""
    executed, issued = (int(v) for v in lane_work[:2])
    return dict(lane_efficiency=executed / issued if issued else 0.0,
                lane_iterations=issued)


def kernel_advance_adaptive(device, grid) -> dict:
    """K11, the adaptive step of the sim_adaptive phase's configuration
    (ctl 5, turbswitch, ifine 4, settling, the polar caps), on 10 x 2**20
    particles spread over the boundary layer of the whole sphere: against
    the plain advance (check_adaptive) as drawn and in cell order (K5, the
    run's order), each timed, with the passes and the warp efficiency of
    each order and the bound from the compiled kernel's instructions per
    pass (k11_instructions)."""
    import copy
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 9)
    cfg, prm = settling_params(grid, turbswitch=True, ifine=4, method=1,
                               settling=True, polar=True)
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    settle = advance.settle_met(z0, cfg)
    p = boundary_layer_particles(N_MAIN, device, 41, grid, itime,
                                 lambda q: sample_met(q, z0.height, tables,
                                                      cfg)[0])
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    ins = k11_instructions(_build.ADVANCE_ADAPTIVE, k11_entry(cfg), cfg.ifine)
    res = {"instructions": ins, "cases": {}}
    for name, q in (("as_drawn", p), ("cell_ordered", ordered)):
        r, pk, dk = check_adaptive(q, z0.height, tables, a, key, cfg, settle,
                                   f"K11 {name}")
        r.update(k11_bound(q, pk, dk.passes, z0.height, cfg, a, ins))
        del pk
        r["ms"] = cuda_ms(lambda: advance.advance_adaptive_cuda(
            q, z0.height, tables, copy.copy(a), key, cfg, None, 0, settle),
            10)
        if name == "cell_ordered":
            r["plain_ms"] = cuda_ms(lambda: advance.advance_all_plain(
                q, z0.height, tables, copy.copy(a), key, cfg, None, 0,
                settle), 1)
        res["cases"][name] = r
        del dk
        torch.cuda.empty_cache()
    check(res["cases"]["as_drawn"]["particles_in_the_loop"] > N_MAIN // 2,
          "K11: fewer than half of the particles took a pass")
    res["ragged"] = k11_ragged_cases(p, z0.height, tables, a, key, cfg,
                                     settle)
    m = res["cases"]["cell_ordered"]
    res.update({f: m[f] for f in (
        "ms", "plain_ms", "bound_ms", "bound_by", "bound_bytes",
        "bound_operations", "bound_instructions", "warp_efficiency",
        "warp_efficiency_pooled", "lane_efficiency", "passes_mean",
        "passes_p99", "passes_max")},
        library_ms=None,
        n=N_MAIN,
        unordered_ms=res["cases"]["as_drawn"]["ms"],
        bitwise=all(c["bitwise"] for c in res["cases"].values()),
        max_abs_err=max(c["max_abs_err"] for c in res["cases"].values()))
    return res


def convective_met(zf, nx_split: int):
    """zf with the 2-D diagnostics of a strong convective boundary layer
    over half the columns (tests/test_matched_rng.py::_make_convective):
    hmix 1500 m, w* 1.8 m/s, L = -25 m from column ``nx_split`` east (-h/L
    = 60: the skewed scheme), L = -1200 m west of it (-h/L = 1.25: the
    Gaussian drift on the raw wp)."""
    import torch
    from flexpart_tpu_torch.met.fields import F2_HMIX, F2_OLI, F2_WSTAR
    f2 = zf.f2d.clone()
    oli = torch.full_like(f2[F2_OLI], 1.0 / -1200.0)
    oli[:, nx_split:] = 1.0 / -25.0
    f2[F2_HMIX] = 1500.0
    f2[F2_WSTAR] = 1.8
    f2[F2_OLI] = oli
    return zf.replace(f2d=f2)


CBL_IFINE = 11      # Command(cblflag=1, ctl=5).ifine_eff


def cbl_params(grid, **cfg_kw):
    """(cfg, prm) of the CBL's adaptive step as Command(cblflag=1, ctl=5)
    makes it: turbswitch, ifine 11, the polar caps, no settling."""
    return settling_params(grid, **{
        "turbswitch": True, "ifine": CBL_IFINE, "method": 1,
        "settling": False, "polar": True, "cblflag": True, **cfg_kw})


def skewed_share(p, height, tables, cfg) -> float:
    """The share of the scheduled boundary-layer particles whose column
    takes the skewed scheme (-h/L > 5)."""
    h, _, _, _, ol, _ = sample_met(p, height, tables, cfg)
    pbl = p.active & (p.z / h <= 1.0)
    zone = pbl & ((-h / ol) > 5.0)
    return int(zone.sum()) / max(int(pbl.sum()), 1)


def kernel_advance_cbl(device, grid) -> dict:
    """K11's CBL instantiation (the skewed convective boundary layer of
    sim_cbl: ctl 5, turbswitch, ifine 11, the polar caps) on 10 x 2**20
    particles spread over the boundary layer of the sphere, SyntheticMet's
    fields with a strong CBL over the eastern half (convective_met): against
    the plain advance (check_adaptive: every output, idt, t_below, the
    passes, the counts and nan_count, bitwise) in cell order, the run's
    order, whose plain run gives ``plain_ms`` (the plain version takes
    seconds here: it runs once); timed as drawn too, and beside the stock
    K11 (TS, the same particles and fields) in both orders.
    Its bound is k11_bound's from the CBL pass body's instructions
    (k11_instructions), whose cheapest path takes the Gaussian side of
    the zone test, plus the skewed work: each skewed substep and fresh
    draw counted on the same particles (cbl_skewed_calls) is charged the
    cheapest path through its function (function_paths), read from the
    CBL part built with the skewed substep as a call (cbl_calls_build:
    the kernel inlines it); the bound without them is reported beside
    it."""
    import copy
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = (convective_met(z, grid.nx // 2) for z in
              met_fields("synthetic", grid, device, (0.0, 10800.0)))
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 13)
    cfg, prm = cbl_params(grid)
    stock = advance.StepConfig(**{**cfg.__dict__, "cblflag": False})
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    a_stock = advance.advance_args(stock, prm, itime, 0, mem1)
    p = boundary_layer_particles(N_MAIN, device, 43, grid, itime,
                                 lambda q: sample_met(q, z0.height, tables,
                                                      cfg)[0])
    ordered = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    ins = k11_instructions(_build.ADVANCE_ADAPTIVE, k11_entry(cfg), cfg.ifine)
    calls_build = cbl_calls_build()
    entry = sass_instantiation(calls_build, "advance_adaptive_kernel",
                               k11_entry(cfg))[0]
    ins["skewed_calls"] = sass_paths(calls_build, CBL_SKEWED_FUNCTIONS,
                                     within=entry)
    res = {"instructions": ins, "cases": {},
           "layout": k11_cbl_layout(_build.ADVANCE_ADAPTIVE),
           "skewed_share": skewed_share(p, z0.height, tables, cfg)}
    for name, q in (("as_drawn", p), ("cell_ordered", ordered)):
        r = {}
        if name == "cell_ordered":
            r, pk, dk = check_adaptive(q, z0.height, tables, a, key, cfg,
                                       None, f"K11 CBL {name}",
                                       time_plain=True)
            r.update(k11_bound(q, pk, dk.passes, z0.height, cfg, a, ins),
                     nan_count=int(dk.nan_count))
            del pk, dk
        r["ms"] = cuda_ms(lambda: advance.advance_adaptive_cuda(
            q, z0.height, tables, copy.copy(a), key, cfg, None, 0), 5)
        r["stock_k11_ms"] = cuda_ms(lambda: advance.advance_adaptive_cuda(
            q, z0.height, tables, copy.copy(a_stock), key, stock, None, 0), 5)
        res["cases"][name] = r
        torch.cuda.empty_cache()
    m = res["cases"]["cell_ordered"]
    m.update(cbl_skewed_bound(m, ordered, z0.height, tables, a, key, cfg,
                              itime))
    m["share_of_bound"] = m["bound_ms"] / m["ms"]
    check(m["particles_in_the_loop"] > N_MAIN // 2,
          "K11 CBL: fewer than half of the particles took a pass")
    check(0.2 < res["skewed_share"] < 0.8,
          f"K11 CBL: {res['skewed_share']} of the boundary layer skewed")
    res.update({f: m[f] for f in (
        "ms", "stock_k11_ms", "plain_ms", "bound_ms", "bound_by",
        "bound_bytes", "bound_operations", "bound_instructions",
        "bound_without_skewed_calls", "skewed_calls", "skewed_paths",
        "skewed_instructions", "share_of_bound", "lane_efficiency",
        "passes_mean", "passes_max", "nan_count")},
        library_ms=None, n=N_MAIN,
        unordered_ms=res["cases"]["as_drawn"]["ms"],
        bitwise=m["bitwise"], max_abs_err=m["max_abs_err"])
    return res


NEST_OUTER = dict(dx=0.5, dy=0.5, xlon0=-20.0, ylat0=20.0, nx=121, ny=101)
NEST_INNER = dict(dx=0.25, dy=0.25, xlon0=-10.0, ylat0=30.0, nx=121, ny=121)
# the nests' SyntheticMet jets (the mother's: 25 m/s): each grid's winds
# and friction velocity differ, so that a particle sampled from the wrong
# grid moves differently
NEST_U_JET = {"outer": 35.0, "inner": 45.0}


def nest_grid(grid, spec):
    """A limited-area nest of ``spec`` on the mother's levels."""
    from flexpart_tpu_torch.met import make_grid
    return make_grid(nlev=grid.nlev, xglobal=False, **spec)


def nest_fields(ngrid, height, device, times, u_jet: float):
    """The nest's ZFields at each time, SyntheticMet with a jet of
    ``u_jet``, processed onto the mother's height grid (the
    verttransform_nests.f90 contract)."""
    from flexpart_tpu_torch.met import calcpar, calcpv, synthetic
    from flexpart_tpu_torch.met import verttransform
    met = synthetic.SyntheticMet(ngrid, u_jet=u_jet)
    out = []
    for t in times:
        eta = met.fetch(t, device)
        out.append(calcpar.calcpar(ngrid, eta, verttransform.process_eta(
            ngrid, eta, height, pvh=calcpv.calcpv(ngrid, eta))))
    return out


def nested_particles(n: int, device, seed: int, grid, itime: int, nests):
    """bench_particles with a third inside the inner nest, a third in the
    outer nest only and a third over the rest of the sphere; half of them
    fresh."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 9)

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    def box(g, lo=0.1, hi=0.9):
        return (u((g.xlon0 + lo * (g.nx - 1) * g.dx - grid.xlon0) / grid.dx,
                  (g.xlon0 + hi * (g.nx - 1) * g.dx - grid.xlon0) / grid.dx),
                u((g.ylat0 + lo * (g.ny - 1) * g.dy - grid.ylat0) / grid.dy,
                  (g.ylat0 + hi * (g.ny - 1) * g.dy - grid.ylat0) / grid.dy))
    outer, inner = nests
    third = u(0.0, 3.0).long()
    xi, yi = box(inner)
    # the outer nest's southern strip lies outside the inner one
    xo, _ = box(outer)
    yo = u((outer.ylat0 + 0.05 * (outer.ny - 1) * outer.dy - grid.ylat0)
           / grid.dy, (inner.ylat0 - 1.0 - grid.ylat0) / grid.dy)
    x = torch.where(third == 0, xi, torch.where(third == 1, xo,
                                                u(0.0, grid.nx - 1.0)))
    y = torch.where(third == 0, yi, torch.where(third == 1, yo,
                                                u(0.0, grid.ny - 1.0)))
    fresh = u(0.0, 1.0) < 0.5
    return p.replace(
        x_hi=x, y_hi=y, z=u(10.0, 3000.0),
        itramem=torch.where(fresh, itime, itime - 7200).to(torch.int32),
        itra=torch.full_like(p.itra, itime),
        up=u(-1.0, 1.0), vp=u(-1.0, 1.0), wp=u(-1.0, 1.0),
        usig=u(-0.3, 0.3), vsig=u(-0.3, 0.3), wsig=u(-0.01, 0.01))


def nest_rows(p, height, cfg, a, k: int, end: bool = False) -> int:
    """Rows of nest k's table that the particles it holds name."""
    import torch
    from flexpart_tpu_torch.core import advance, interp
    nnx, nny = cfg.nests[k]
    idx = advance.nest_index(cfg, a, p.x, p.y)
    held = p.active & (idx == k)
    xt, yt = advance._nest_coords(a, k, p.x, p.y)
    hw = interp.horiz_weights(xt, yt, nnx, nny, False)
    indz, _ = interp.vert_weights(p.z, height)
    rows = interp._cell_rowid(hw, indz, nnx, nny)[held]
    return int(torch.unique(rows).numel())


def kernel_advance_nests(device, grid) -> dict:
    """K4's NESTS instantiation (sim_nested's configuration: the stock
    step, the polar caps) with two nested windows, 0.5 degrees over
    20 W-40 E, 20-70 N and 0.25 degrees over 10 W-20 E, 30-60 N, each with
    its own jet (NEST_U_JET), on 10 x 2**20 particles, a third in the
    inner nest, a third in the outer one only: against the plain advance
    with K1's draws injected, every output bitwise (compare_particles'
    K4 tolerances reported beside), in cell order, timed beside the stock
    K4 on the same particles, whose positions must differ from K4
    NESTS's for nearly every particle in a nest (the nests' winds are
    used).  Bound: K4's bytes plus each nest row its particles name, 128 B
    of the start table and 48 B of the end table."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.run.simulation import nest_windows
    from flexpart_tpu_torch.met import synthetic, verttransform
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    height = verttransform.compute_heights(
        grid, synthetic.SyntheticMet(grid).fetch(0.0, device))
    nests = (nest_grid(grid, NEST_OUTER), nest_grid(grid, NEST_INNER))
    zn = [nest_fields(g, height, device, (0.0, 10800.0), NEST_U_JET[w])
          for g, w in zip(nests, ("outer", "inner"))]
    itime, mem1 = 3600, 10800
    key = rng.Key(4321, 19)
    cfg, _, *_ = step_setup(grid, polar=True,
                            nests=tuple((g.nx, g.ny) for g in nests))
    prm = advance.StepParams.make(
        dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0, dxconst=grid.dxconst,
        dyconst=grid.dyconst, lsynctime=LSYNC, fine=1.0 / cfg.ifine,
        **nest_windows(grid, nests))
    stock = advance.StepConfig(**{**cfg.__dict__, "nests": ()})
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    tables_n = tuple(interp.build_step_tables_quad(
        zk[0], zk[1], *tw, dtype=cfg.table_dtype) for zk in zn)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    a_stock = advance.advance_args(stock, prm, itime, 0, mem1)
    drawn = nested_particles(N_MAIN, device, 47, grid, itime, nests)
    p = reorder.reorder_by_cell_cuda(drawn, z0.height, cfg)[0]
    idx = advance.nest_index(cfg, a, p.x, p.y)
    share = {"inner": int((idx == 1).sum()) / N_MAIN,
             "outer_only": int((idx == 0).sum()) / N_MAIN}
    check(min(share.values()) > 0.25, f"K4 NESTS: nest shares {share}")
    draws = {tag: rng.normals(key, (rows, N_MAIN), tag, 0, device=device)
             for tag, rows in advance.draw_tags(cfg).items()}
    args = (p, z0.height, tables, a, key, cfg)
    pk, dk = advance.advance_all_cuda(*args, draws, 0, tables_n=tables_n)
    pp, dp = advance.advance_all_plain(*args, draws, 0, tables_n=tables_n)
    torch.cuda.synchronize()
    res = compare_particles(pk, pp, "K4 NESTS", float(grid.nx - 1))
    differ = differing_particles(pk, pp, advance.OUT_FIELDS)
    check(differ == 0, f"K4 NESTS differs from its plain version in "
          f"{differ} particles")
    # the same draws through the stock K4: a particle a nest holds moves
    # with the nest's winds, so its position differs
    ps = advance.advance_all_cuda(p, z0.height, tables, a_stock, key, stock,
                                  draws, 0)[0]
    held = p.active & (idx >= 0)
    moved = (pk.x != ps.x) | (pk.y != ps.y)
    moved_share = int((moved & held).sum()) / max(int(held.sum()), 1)
    check(moved_share > 0.9, f"K4 NESTS: only {moved_share} of the nests' "
          "particles move otherwise than with the mother's met")
    del ps
    res.update(differing_particles=differ, bitwise=differ == 0,
               max_abs_err=max(res["max_dx"], res["max_dy"]),
               nest_share=share, n=N_MAIN,
               nest_particles_moved_otherwise_share=moved_share)
    check_same_bits(advance.advance_all_cuda(*args, None, 0,
                                             tables_n=tables_n)[0],
                    advance.advance_all_cuda(*args, None, 0,
                                             tables_n=tables_n)[0],
                    "K4 NESTS: twice")
    rows = {"start": sum(nest_rows(p, z0.height, cfg, a, k)
                         for k in range(len(nests))),
            "end": sum(nest_rows(pk, z0.height, cfg, a, k)
                       for k in range(len(nests)))}
    row_b = 128 if cfg.met_bf16 else 256
    rows0 = unique_rows(p, z0.height, cfg)
    rows1 = unique_rows(pk, z0.height, cfg)
    del pk, pp, draws
    torch.cuda.empty_cache()
    res.update(
        ms=cuda_ms(lambda: advance.advance_all_cuda(
            *args, None, 0, tables_n=tables_n), 10),
        stock_k4_ms=cuda_ms(lambda: advance.advance_all_cuda(
            p, z0.height, tables, a_stock, key, stock, None, 0), 10),
        # what K5's mother-cell order is worth to the nests' gathers: the
        # same particles as drawn
        unordered_ms=cuda_ms(lambda: advance.advance_all_cuda(
            drawn, z0.height, tables, a, key, cfg, None, 0,
            tables_n=tables_n), 10),
        stock_k4_unordered_ms=cuda_ms(lambda: advance.advance_all_cuda(
            drawn, z0.height, tables, a_stock, key, stock, None, 0), 10),
        plain_ms=cuda_ms(lambda: advance.advance_all_plain(
            *args, None, 0, tables_n=tables_n), 2),
        library_ms=None, nest_rows=rows,
        **bound(104 * N_MAIN + row_b * (rows0 + rows["start"])
                + row_b * 3 // 8 * (rows1 + rows["end"]),
                K4_OPS_PER_PARTICLE * N_MAIN))
    return res


def k11_ragged_cases(p, height, tables, a, key, cfg, settle) -> dict:
    """K11 against the plain advance (check_adaptive: bitwise, the passes,
    t_below and the counts) on the edges of its refilled lanes, cut from the
    spread ensemble ``p`` as drawn: 17 particles (fewer than a warp), 257
    (a block and one), 10,000 (fewer than the card holds at once: 132 SMs
    x 1,024 threads), 2**16 that all start above h (no pass), and the
    particle with the most passes among 63 that take none: it sits on slot
    5 (its own, if lower), and the draw counter's offset gives it its own
    global index, so it takes the passes it takes in ``p``."""
    import copy
    import torch
    from flexpart_tpu_torch.core import advance
    from flexpart_tpu_torch.core.state import FIELDS, Particles

    def take(idx):
        return Particles(**{f: getattr(p, f)[idx] for f in FIELDS})

    passes = advance.advance_adaptive_cuda(
        p, height, tables, copy.copy(a), key, cfg, None, 0, settle)[1].passes
    dev = passes.device
    idle = torch.nonzero(p.active & (passes == 0)).flatten()
    top = int(torch.argmax(passes))
    check(idle.numel() >= 2 ** 16, f"K11: {idle.numel()} zero-pass particles")
    cases = {f"n{k}": torch.arange(k, device=dev) for k in (17, 257, 10000)}
    cases["above_h"] = idle[:2 ** 16]
    pos = min(5, top)
    cases["one_long_among_idle"] = torch.cat([
        idle[:pos], torch.tensor([top], device=dev), idle[pos:63]])
    out = {}
    for name, idx in cases.items():
        offset = top - pos if name == "one_long_among_idle" else 0
        r, _, dk = check_adaptive(take(idx), height, tables, a, key, cfg,
                                  settle, f"K11 ragged {name}", offset)
        out[name] = {f: r[f] for f in ("bitwise", "differing_particles",
                                       "n_active", "passes_total",
                                       "lane_efficiency")}
        out[name]["n"] = int(idx.numel())
        out[name]["passes_max"] = int(dk.passes.max())
    check(out["above_h"]["passes_total"] == 0, "K11: a particle above h "
          "took a pass")
    check(out["one_long_among_idle"]["passes_max"] == int(passes[top]) >= 8,
          f"K11: the long particle took {out['one_long_among_idle']}")
    return out


def sounding_eta(grid, device):
    """The moist-unstable sounding of tests/test_convection.py::_soundings
    at every column of ``grid``, on the grid's own eta levels at ps =
    101325 Pa: T falls 6.5 K/km from 300 K (floor 200 K) with z = -7500 m
    ln(p/ps), q = 0.92 q_sat(p, T) exp(-z / 3000 m) with the port's
    f_qvsat; tt2 = 302 K, td2 = 300 K.  Returns the (ps, tth, qvh, tt2,
    td2) tensors K6 takes."""
    import numpy as np
    import torch
    from flexpart_tpu_torch.met.thermo import f_qvsat
    ps = 101325.0
    p = np.asarray(grid.akz) + np.asarray(grid.bkz) * ps
    z = -7500.0 * np.log(np.maximum(p, 1.0) / ps)
    t = np.maximum(300.0 - 6.5e-3 * z, 200.0)
    qsat = f_qvsat(torch.as_tensor(p), torch.as_tensor(t)).numpy()
    q = 0.92 * qsat * np.exp(-z / 3000.0)
    shape = (grid.ny, grid.nx)

    def col(v):
        return torch.as_tensor(np.asarray(v, np.float32)[:, None, None]
                               .repeat(grid.ny, 1).repeat(grid.nx, 2),
                               device=device).contiguous()

    def flat(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return (flat(ps), col(t), col(q), flat(302.0), flat(300.0))


def check_convection(kern, fields, cbmf, what: str, tw=CONV_TW) -> tuple:
    """K6 against its plain pipeline on the same fields and time weights,
    every output bitwise: (kernel's outputs, plain outputs, the
    comparison)."""
    import torch
    from flexpart_tpu_torch.physics import convection as cv
    k = cv.convection_cuda(kern, fields, *tw, cbmf, float(LSYNC))
    p = cv.convection_plain(kern, fields, *tw, cbmf, float(LSYNC))
    torch.cuda.synchronize()
    worst, differ = 0.0, 0
    for f in cv.ConvectionFields._fields:
        a, b = getattr(k, f), getattr(p, f)
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{what}: K6 {f} is {a.dtype} {tuple(a.shape)}")
        if not b.dtype.is_floating_point:
            n = int((a != b).sum())
            check(n == 0, f"{what}: K6 {f} differs in {n} columns")
            continue
        d = (a - b).abs()
        check(bool(torch.isfinite(a).all()), f"{what}: K6 {f} not finite")
        n = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        check(n == 0, f"{what}: K6 {f} differs from the plain version's in "
              f"{n} values, by up to {float(d.max())}")
        worst = max(worst, float(d.max()))
        differ += n
    return k, p, dict(max_abs_err=worst, values_differ=differ,
                      convecting_columns=int(k.lconv.sum()),
                      columns=int(k.lconv.numel()))


def redist_args(conv, kern, grid, itime: int = 0) -> tuple:
    """The arguments of redist_cuda / redist_plain after the key."""
    return (conv.fmassfrac, conv.rlevmass, conv.phconv, conv.sub,
            conv.uvzlev, conv.pconv, conv.tconv, conv.lconv, LSYNC, itime,
            kern.nl, grid.nx, grid.ny)


def check_redist(p, key, conv, kern, grid, rn, what: str,
                 itime: int = 0, ldirect: int = 1) -> dict:
    """K7 against redist_plain on the same particles and matrices:
    z bitwise and the moved counts equal.  Both sum each cumulative row in
    level order and spell every operation alike, so any difference is a
    fault (a level is chosen by a comparison: one ulp in a cumulative
    fraction moves a particle to another level).  ``ldirect`` -1: K7's
    BACKWARD instantiation against the plain version's transposed
    matrix."""
    import torch
    from flexpart_tpu_torch.physics import convection as cv
    args = redist_args(conv, kern, grid, itime)
    qk, mk = cv.redist_cuda(p, key, *args, rn=rn, ldirect=ldirect)
    qp, mp = cv.redist_plain(p, key, *args, rn=rn, ldirect=ldirect)
    torch.cuda.synchronize()
    n = p.capacity
    d = (qk.z - qp.z).abs()
    differ = int((qk.z.view(torch.int32) != qp.z.view(torch.int32)).sum())
    check(differ == 0, f"{what}: K7 z differs from the plain version's for "
          f"{differ} of {n} particles, by up to {float(d.max())} m")
    check(int(mk) == int(mp),
          f"{what}: K7 moved {int(mk)}, the plain version {int(mp)}")
    check(bool(torch.isfinite(qk.z).all()), f"{what}: K7 z not finite")
    return dict(moved=int(mk), plain_moved=int(mp), z_differ=differ,
                max_abs_err=float(d.max()))


def k7_bound(p, conv, kern, grid, itime: int = 0) -> dict:
    """K7's least time on these inputs: the particle state read (25 B) and
    z written (4 B) once, the flags of every column once, and, for the
    particles that convection may move (scheduled, in a convecting
    column), each distinct column's profiles and each distinct matrix row
    once."""
    import torch
    L1 = kern.L1
    ix = torch.clamp(torch.round(p.x).long(), 0, grid.nx - 1)
    jy = torch.clamp(torch.round(p.y).long(), 0, grid.ny - 1)
    col = jy * grid.nx + ix
    live = p.active & (p.itra == itime) & conv.lconv[col]
    uvz = conv.uvzlev[col[live]]
    lev = torch.clamp((uvz[:, 1:L1] < p.z[live][:, None]).sum(1), 0, L1 - 1)
    cols = int(torch.unique(col[live]).numel())
    rows = int(torch.unique(col[live] * L1 + lev).numel())
    n_bytes = (29 * p.capacity + conv.lconv.numel()
               + cols * 4 * (2 * (L1 + 1) + 5 * L1) + rows * 4 * L1)
    n_ops = K7_OPS_PER_PARTICLE * p.capacity \
        + K7_OPS_PER_LIVE_LEVEL * L1 * int(live.sum())
    return dict(live=int(live.sum()), live_columns=cols, **bound(n_bytes,
                                                                 n_ops))


def convection_cases(grid, device) -> dict:
    """K6's inputs on ``grid``: SyntheticMet's two met times (a sixth of
    the columns convect at 1 degree) and the moist-unstable sounding at
    every column (all convect, every branch of the scheme is entered)."""
    from flexpart_tpu_torch.met import synthetic
    met = synthetic.SyntheticMet(grid)
    eta = ("ps", "tth", "qvh", "tt2", "td2")
    e0, e1 = (met.fetch(t, device) for t in (0.0, 3600.0))
    sound = sounding_eta(grid, device)
    return {"synthetic": tuple(getattr(e0, n) for n in eta)
            + tuple(getattr(e1, n) for n in eta),
            "sounding": sound + sound}


def spin_up(kern, fields, C: int, device, what: str) -> tuple:
    """CONV_SPINUP steps of the flux memory's feedback, K6 held bitwise
    against its plain pipeline at every step: (the last step's K6
    outputs, the flux memory it was given, the comparisons)."""
    import torch
    cbmf = torch.zeros(C, dtype=torch.float32, device=device)
    steps = []
    for s in range(CONV_SPINUP):
        k, p, cmp_ = check_convection(kern, fields, cbmf, f"{what} step {s}")
        steps.append(cmp_)
        if s + 1 < CONV_SPINUP:
            cbmf = p.cbmf
    return k, cbmf, steps


def kernel_convection(device, grid) -> tuple[dict, dict, dict]:
    """K6 and K7 against their plain versions at full width.  K6 on both
    convection_cases of the bench grid (L1 = 26: one warp per column, a
    level per lane), each through CONV_SPINUP steps compared bitwise at
    every step, and timed; then on the same two cases of two taller grids
    (K6_TALL: L1 = 68 and 126, two to four levels per lane, two columns per
    block at 126), bitwise.  K7 on 10 x 2**20 particles against the
    matrices of both bench-grid cases, with injected uniforms and with its
    own, in three orders: as drawn, sorted by met cell (K5, the order the
    run gives K7), and the sorted particles' result held against the
    unsorted ones' mapped through ``perm`` (each particle's result must not
    depend on the lanes beside it); the sounding case must move
    particles.  K7's BACKWARD instantiation (a backward run's transposed
    matrix) the same way on the cell-ordered particles, its own uniforms
    and injected ones; it too must move particles on the sounding."""
    import torch
    from flexpart_tpu_torch.core import reorder, rng
    from flexpart_tpu_torch.met import synthetic
    from flexpart_tpu_torch.physics import convection as cv
    kern = cv.make_convection_kernel(grid)
    C, L1 = grid.nx * grid.ny, kern.L1
    k6, k7, k7b, last = {}, {}, {}, {}
    for name, fields in convection_cases(grid, device).items():
        k, cbmf, steps = spin_up(kern, fields, C, device, f"K6 {name}")
        last[name] = k
        k6[name] = dict(
            steps=steps, convecting_columns=steps[-1]["convecting_columns"],
            max_abs_err=max(c["max_abs_err"] for c in steps),
            values_differ=sum(c["values_differ"] for c in steps),
            nctop_max=int(k.nctop.max()),
            ms=cuda_ms(lambda: cv.convection_cuda(kern, fields, *CONV_TW,
                                                  cbmf, float(LSYNC)), 10),
            plain_ms=cuda_ms(lambda: cv.convection_plain(
                kern, fields, *CONV_TW, cbmf, float(LSYNC)), 2))
        del fields, cbmf
    check(k6["synthetic"]["convecting_columns"] > 0,
          "K6: no column of SyntheticMet convects")
    check(k6["sounding"]["convecting_columns"] == C,
          f"K6: {k6['sounding']['convecting_columns']} of {C} columns "
          "convect on the moist-unstable sounding")
    tall = {}
    for nlev in K6_TALL:
        g = synthetic.make_grid(nx=K6_TALL_NX, ny=K6_TALL_NY, nlev=nlev)
        kt = cv.make_convection_kernel(g)
        check(32 < kt.L1 <= cv.K6_MAX_LEVELS, f"K6 tall grid: L1 = {kt.L1}")
        t = dict(L1=kt.L1, columns=g.nx * g.ny, **cv.k6_layout(kt.nl))
        for name, fields in convection_cases(g, device).items():
            k, _, steps = spin_up(kt, fields, g.nx * g.ny, device,
                                  f"K6 L1={kt.L1} {name}")
            t[name] = dict(convecting_columns=steps[-1]["convecting_columns"],
                           values_differ=sum(c["values_differ"]
                                             for c in steps))
        check(t["sounding"]["convecting_columns"] == g.nx * g.ny,
              f"K6 L1={kt.L1}: not every column convects on the sounding")
        tall[f"L1_{kt.L1}"] = t
        del k, fields
    # in: per column and met time the L1 profile levels of tth and qvh and
    # ps, tt2, td2, then cbmf, and the grid's coefficients (akz, bkz at L1
    # levels, akm, bkm at L1 + 1); out: fmassfrac, four profiles of L1, two
    # of L1 + 1, cbmf, nctop and the flags
    k6_bytes = 4 * C * (2 * (2 * L1 + 3) + 1) + 4 * (4 * L1 + 2) \
        + C * (4 * (L1 * L1 + 4 * L1 + 2 * (L1 + 1) + 2) + 1)
    conv_res = dict(
        nl=kern.nl, L1=L1, columns=C, cases=k6, library_ms=None,
        library="none", layout=cv.k6_layout(kern.nl), tall=tall,
        max_abs_err=max(c["max_abs_err"] for c in k6.values()),
        values_differ=sum(c["values_differ"] for c in k6.values()),
        ms=k6["synthetic"]["ms"], plain_ms=k6["synthetic"]["plain_ms"],
        all_convecting_ms=k6["sounding"]["ms"],
        **bound(k6_bytes, k6_ops_per_column(L1) * C))

    p = bench_particles(N_MAIN, device, seed=13)
    key = rng.Key(4321, 7)
    gen = torch.Generator(device=device)
    gen.manual_seed(17)
    rn = torch.rand(N_MAIN, generator=gen, device=device)
    height = met_fields("synthetic", grid, device)[0].height
    cfg = step_setup(grid)[0]
    q, perm = reorder.reorder_by_cell_cuda(p, height, cfg)
    perm = perm.long()
    rn_q = rn[perm]
    for name, conv in last.items():
        args = redist_args(conv, kern, grid)
        case = {}
        for order, pp, u in (("unordered", p, rn), ("cell_ordered", q, rn_q)):
            c = {draw: check_redist(pp, key, conv, kern, grid, uu,
                                    f"K7 {name}, {order}, {draw} uniforms")
                 for draw, uu in (("injected", u), ("in_registers", None))}
            c.update(k7_bound(pp, conv, kern, grid),
                     ms=cuda_ms(lambda: cv.redist_cuda(pp, key, *args), 10),
                     plain_ms=cuda_ms(lambda: cv.redist_plain(pp, key, *args),
                                      2))
            case[order] = c
        # the sorted particles' result is the unsorted ones' through perm
        zu, mu = cv.redist_cuda(p, key, *args, rn=rn)
        zs, ms_ = cv.redist_cuda(q, key, *args, rn=rn_q)
        check_same_bits(zs, zu.replace(z=zu.z[perm]),
                        f"K7 {name}: sorted vs unsorted through perm", ("z",))
        check(int(ms_) == int(mu), f"K7 {name}: sorted moved {int(ms_)}, "
              f"unsorted {int(mu)}")
        case["sorted_equals_unsorted_through_perm"] = True
        del zu, zs
        k7[name] = case
        c = {draw: check_redist(q, key, conv, kern, grid, uu,
                                f"K7 BACKWARD {name}, {draw} uniforms",
                                ldirect=-1)
             for draw, uu in (("injected", rn_q), ("in_registers", None))}
        c.update(k7_bound(q, conv, kern, grid),
                 ms=cuda_ms(lambda: cv.redist_cuda(q, key, *args,
                                                   ldirect=-1), 10),
                 plain_ms=cuda_ms(lambda: cv.redist_plain(q, key, *args,
                                                          ldirect=-1), 2))
        k7b[name] = c
    check(all(k7["sounding"][o][d]["moved"] > 0 for o in ("unordered",
                                                          "cell_ordered")
              for d in ("injected", "in_registers")),
          "K7: no particle moved on the convecting case")
    check(all(k7b["sounding"][d]["moved"] > 0 for d in ("injected",
                                                        "in_registers")),
          "K7 BACKWARD: no particle moved on the convecting case")
    del p, q, perm, rn, rn_q, last
    steady = k7["synthetic"]["cell_ordered"]
    redist_res = dict(
        n=N_MAIN, cases=k7, library_ms=None, library="none",
        max_abs_err=max(c[o][d]["max_abs_err"] for c in k7.values()
                        for o in ("unordered", "cell_ordered")
                        for d in ("injected", "in_registers")),
        moved=k7["sounding"]["cell_ordered"]["in_registers"]["moved"],
        ms=steady["ms"], plain_ms=steady["plain_ms"],
        unordered_ms=k7["synthetic"]["unordered"]["ms"],
        unordered_bound_ms=k7["synthetic"]["unordered"]["bound_ms"],
        all_convecting_ms=k7["sounding"]["cell_ordered"]["ms"],
        all_convecting_bound_ms=k7["sounding"]["cell_ordered"]["bound_ms"],
        all_convecting_unordered_ms=k7["sounding"]["unordered"]["ms"],
        **{f: steady[f] for f in ("bound_ms", "bound_by", "bound_bytes",
                                  "bound_operations")})
    # the backward run's case: SyntheticMet's matrices, cell order
    back = k7b["synthetic"]
    backward_res = dict(
        n=N_MAIN, cases=k7b, library_ms=None, bitwise=True,
        max_abs_err=max(c[d]["max_abs_err"] for c in k7b.values()
                        for d in ("injected", "in_registers")),
        moved=k7b["sounding"]["in_registers"]["moved"],
        all_convecting_ms=k7b["sounding"]["ms"],
        all_convecting_bound_ms=k7b["sounding"]["bound_ms"],
        **{f: back[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "bound_bytes", "bound_operations")})
    return conv_res, redist_res, backward_res


# ------------------------------------------------------------ deposition --

def depo_species():
    """The deposition kernels' species in the kernels phase: an I-131-like
    aerosol without settling (below-cloud rain and snow, in-cloud CCN and
    IN, a constant dry velocity, an 8-day half-life) and an SO2-like gas
    (below-cloud A * P**B, the Henry rule in cloud, a constant dry
    velocity, no decay)."""
    from flexpart_tpu_torch.config import Species
    return (Species(name="I-131", decay_halflife=8.02 * 86400.0,
                    crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                    in_aero=0.1, dquer=0.4, dryvel=1.0e-3),
            Species(name="SO2", weta_gas=1.0e-4, wetb_gas=0.62, henry=1.0e5,
                    dryvel=0.01))


def depo_particles(n: int, device, seed: int, grid, nspec: int = 2):
    """n particles over the whole sphere at 0-3000 m, a third of them below
    2 HREF (30 m), 1/32 inactive, released over the last three hours, with
    nspec masses of 1/n and their released masses a bit larger; every
    1000th has kept less than minmass of the released mass."""
    import torch
    from flexpart_tpu_torch.core.state import empty_particles
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo, hi, shape=(n,)):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    low = u(0.0, 1.0) < 1.0 / 3.0
    mass = u(0.5, 1.5, (n, nspec)) / n
    mass0 = mass * u(1.0, 1.5, (n, nspec))
    spent = torch.arange(n, device=device) % 1000 == 0
    mass = torch.where(spent[:, None], mass0 * 1.0e-5, mass)
    p = empty_particles(n, nspec, device=device)
    return p.replace(
        x_hi=u(0.0, grid.nx - 1.0), y_hi=u(0.0, grid.ny - 1.0),
        x_lo=u(-1e-6, 1e-6), y_lo=u(-1e-6, 1e-6),
        z=torch.where(low, u(0.0, 30.0), u(0.0, 3000.0)),
        itra=torch.full((n,), 10800, dtype=torch.int32, device=device),
        itramem=u(0.0, 10800.0).to(torch.int32),
        active=u(0.0, 1.0) >= 1.0 / 32, mass=mass, mass0=mass0)


def plume_particles(n: int, device, seed: int, grid):
    """n particles inside the sim phase's first release box (40-42 N, 0-2 E,
    the lowest 2 km), all active, released over the last three hours (two
    age classes at 10800 s), and two deposits: ``plume_dense`` (species 0
    zero, species 1 positive for every particle) and ``plume_sparse``
    (species 1 positive for 5% of them).  The deposit scatter (K8) on a
    plume: a few output cells, each taking the pairs of some 10**5-10**6
    particles."""
    import torch
    from flexpart_tpu_torch.core.state import empty_particles
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    x0 = (0.0 - grid.xlon0) / grid.dx
    y0 = (40.0 - grid.ylat0) / grid.dy
    p = empty_particles(n, 2, device=device).replace(
        x_hi=u(x0, x0 + 2.0 / grid.dx), y_hi=u(y0, y0 + 2.0 / grid.dy),
        x_lo=u(-1e-6, 1e-6), y_lo=u(-1e-6, 1e-6), z=u(0.0, 2000.0),
        itra=torch.full((n,), 10800, dtype=torch.int32, device=device),
        itramem=u(0.0, 10800.0).to(torch.int32),
        active=torch.ones(n, dtype=torch.bool, device=device))
    dep = u(0.5, 1.5) / n
    zero = torch.zeros_like(dep)
    sparse = torch.where(u(0.0, 1.0) < 0.05, dep, zero)
    return p, {"plume_dense": torch.stack([zero, dep]),
               "plume_sparse": torch.stack([zero, sparse])}


def all_classes_met(zf, device, seed: int):
    """zf with every cloud class 0-5 (SyntheticMet's clouds start at level 1
    and are 0-3: no below-cloud cell) and temperatures of 245-280 K (its
    cloud levels stay above 273 K: no ice, no snow), from a seed."""
    import torch
    from flexpart_tpu_torch.met.fields import F3_TT
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    clouds = torch.randint(0, 6, zf.clouds.shape, generator=gen,
                           device=device).to(torch.int8)
    f3d = zf.f3d.clone()
    f3d[F3_TT] = torch.rand(f3d[F3_TT].shape, generator=gen,
                            device=device) * 35.0 + 245.0
    return zf.replace(clouds=clouds, f3d=f3d)


def bits_or_close(k, p, rtol: float, what: str) -> dict:
    """A kernel's float32 output against its plain version's: bitwise, or
    every value within ``rtol`` of the plain one; the count of values whose
    bits differ is reported either way."""
    import torch
    differ = int((k.view(torch.int32) != p.view(torch.int32)).sum())
    err = float((k - p).abs().max()) if k.numel() else 0.0
    if differ:
        check(bool(torch.all((k - p).abs() <= rtol * p.abs())),
              f"{what}: {differ} values differ, beyond rtol {rtol}: max abs "
              f"{err}")
    return dict(values_differ=differ, max_abs_err=err)


def check_wetdepo(p, zf, wet, msp, ldeltat: int, what: str,
                  clwc: bool = False) -> dict:
    """K9 (``clwc``: K9 CLWC) against the plain chain (wetscav_all_plain +
    apply_wetdepo_plain, with the column cloud water for ``clwc``) on the
    card: the mass and the deposit, bitwise or within K9_RTOL; the share of
    the active particles that each species scavenges."""
    import torch
    from flexpart_tpu_torch.physics import massupdate as mu
    from flexpart_tpu_torch.physics import wetdepo as wd
    qk, dk = wd.wetdepo_cuda(p, zf, LSYNC, ldeltat, wet, msp, clwc)
    lam, grf = wd.wetscav_all_plain(p, zf, wet, clwc)
    qp, dp = mu.apply_wetdepo_plain(p, lam, grf, LSYNC, ldeltat, msp)
    torch.cuda.synchronize()
    m = bits_or_close(qk.mass, qp.mass, K9_RTOL, f"{what}: K9 mass")
    d = bits_or_close(dk, dp, K9_RTOL, f"{what}: K9 deposit")
    n_on = max(int(p.active.sum()), 1)
    return dict(values_differ=m["values_differ"] + d["values_differ"],
                max_abs_err=max(m["max_abs_err"], d["max_abs_err"]),
                bitwise=m["values_differ"] + d["values_differ"] == 0,
                scavenged_share=[float((lam[s] > 0).sum()) / n_on
                                 for s in range(lam.shape[0])],
                deposit=dk)


def check_drydepo(p, vdep, msp, ldeltat: int, what: str,
                  t_below=None) -> dict:
    """K10 against apply_decay_drydep_plain on the card: mass and deposit
    bitwise or within K10_RTOL, the active mask equal; with ``t_below``
    its T_BELOW instantiation (the adaptive step's window)."""
    import torch
    from flexpart_tpu_torch.physics import massupdate as mu
    qk, dk = mu.decay_drydep_cuda(p, vdep, LSYNC, ldeltat, msp, True,
                                  t_below)
    qp, dp = mu.apply_decay_drydep_plain(p, vdep, LSYNC, ldeltat, msp, True,
                                         t_below)
    torch.cuda.synchronize()
    m = bits_or_close(qk.mass, qp.mass, K10_RTOL, f"{what}: K10 mass")
    d = bits_or_close(dk, dp, K10_RTOL, f"{what}: K10 deposit")
    ended = int((p.active & ~qp.active).sum())
    check(torch.equal(qk.active, qp.active), f"{what}: K10 active differs in "
          f"{int((qk.active != qp.active).sum())} particles")
    return dict(values_differ=m["values_differ"] + d["values_differ"],
                max_abs_err=max(m["max_abs_err"], d["max_abs_err"]),
                bitwise=m["values_differ"] + d["values_differ"] == 0,
                ended_by_minmass=ended,
                depositing_share=float((dp > 0).any(dim=0).sum())
                / max(int(p.active.sum()), 1), deposit=dk)


def check_depo_scatter(p, deposit, itime: int, lage, ccfg, what: str) -> dict:
    """K8 against the float64 sum of its own pairs: any order of m float32
    additions of non-negative terms stays within m * 2**-24 of it,
    relatively, so a cell of m pairs is held within max(m * 2**-24,
    K8_RTOL); the plain version (index_add_, one float atomic per pair) is
    held to the same rule, and the library call (index_add_ of the
    kernel's own valid pairs) is timed beside both."""
    import torch
    from flexpart_tpu_torch.physics import wetdepo as wd
    nspec = deposit.shape[0]
    rows = ccfg.nage * ccfg.nclassunc * ccfg.npointspec * ccfg.nyg * ccfg.nxg
    dev = deposit.device
    flat_k = torch.zeros((rows, nspec), dtype=torch.float32, device=dev)
    flat_p = torch.zeros_like(flat_k)
    wd.depo_scatter_cuda(flat_k, deposit, p, itime, lage, ccfg)
    nage_idx = wd.depo_age_class(p, itime, lage, ccfg.nage)
    kp = (p.npoint if ccfg.ioutputforeachrelease
          else torch.zeros_like(p.npoint)).long()
    wd.depo_scatter_plain(flat_p, deposit, p, nage_idx, kp, ccfg)
    lin, valid, contrib = wd.depo_pairs(rows, deposit, p, nage_idx, kp, ccfg)
    lin, contrib = lin[valid], contrib[valid]
    n_pairs = int(lin.numel())
    # the library call: index_add_ of the kernel's own valid pairs, made
    # outside the timed region (the scatter half of the function)
    flat_l = torch.zeros_like(flat_k)
    library_ms = cuda_ms(lambda: flat_l.index_add_(0, lin, contrib), 3)
    del flat_l
    ref = torch.zeros((rows, nspec), dtype=torch.float64, device=dev)
    ref.index_add_(0, lin, contrib.double())
    pairs = torch.zeros(rows, dtype=torch.int64, device=dev)
    pairs.index_add_(0, lin, torch.ones_like(lin))
    del lin, valid, contrib
    rtol = torch.clamp(pairs.double() * 2.0 ** -24, min=K8_RTOL)[:, None]
    check(float(ref.sum()) > 0.0, f"{what}: K8 deposits nothing")
    rel = {}
    for who, flat in (("kernel", flat_k), ("plain", flat_p)):
        d = (flat.double() - ref).abs()
        rel[who] = float((d / ref.clamp(min=1e-300)).max())
        check(bool(torch.all(d <= rtol * ref)),
              f"{what}: K8 {who}: a cell is further from the float64 sum of "
              f"its pairs than their count allows, max rel {rel[who]}")
    out = dict(max_abs_err=float((flat_k.double() - ref).abs().max()),
               max_rel_err_vs_f64=rel["kernel"],
               plain_max_rel_err_vs_f64=rel["plain"],
               total_rel_err_vs_f64=abs(float(flat_k.sum(dtype=torch.float64))
                                        / float(ref.sum()) - 1.0),
               pairs=n_pairs, cells_hit=int((pairs != 0).sum()),
               most_pairs_in_a_cell=int(pairs.max()))
    out["ms"] = cuda_ms(lambda: wd.depo_scatter_cuda(
        flat_k, deposit, p, itime, lage, ccfg), 10)
    out["plain_ms"] = cuda_ms(lambda: wd.depo_scatter_plain(
        flat_p, deposit, p, nage_idx, kp, ccfg), 3)
    out["library_ms"] = library_ms
    return out


def elf_functions(kernel, within: str = "") -> dict:
    """The functions of a kernel's library from the cubin's symbol table
    (cuobjdump -elf): {symbol: (first byte, bytes)}, those whose symbol
    holds ``within`` (an instantiation's copies of its functions)."""
    import re
    starts = {}
    for ln in kernel.cuobjdump("-elf").splitlines():
        m = re.match(r"\s*0x[0-9a-f]+\s+(0x[0-9a-f]+|0)\s+(0x[0-9a-f]+|0)"
                     r"\s+\S+\s+\S+\s+\S+\s+(\$\S+)\s*$", ln)
        if m and int(m.group(2), 16) > 0 and within in m.group(3):
            starts[m.group(3)] = (int(m.group(1), 16), int(m.group(2), 16))
    return starts


def function_paths(kernel, template: str, flags, functions) -> dict:
    """The cheapest path (``sass_path``) through each named __noinline__
    function of one instantiation (sass_instantiation's ``template`` and
    ``flags``), from its first instruction to the nearest RET it can
    reach, a CALL on it counted as one instruction and its stores and
    loads of local memory (local_memory: spills and the call's frame)
    not at all; with the function's static instructions, the local-memory
    ones and the CALLs in it beside it."""
    import re
    name, code = sass_instantiation(kernel, template, flags)
    starts = elf_functions(kernel, name)
    out = {}
    for f in functions:
        hit = [vs for sym, vs in starts.items()
               if re.search(r"\d%sE" % f, sym)]
        check(len(hit) == 1, f"{kernel.name}: function {f} not found once "
              f"in {name}")
        lo, size = hit[0]
        body = [c for c in code if lo <= c[0] < lo + size]
        local = local_memory(code, lo, lo + size - 1)
        paths = []
        for a, op, _, _, _ in body:
            if op.startswith("RET"):
                try:
                    paths.append(sass_path(code, lo, a, free=local))
                except AssertionError:
                    pass
        check(bool(paths), f"{kernel.name}: no RET reached in {f}")
        out[f] = dict(cheapest=min(paths),
                      static=sum(1 for c in body if c[1] != "NOP"),
                      local_memory=len(local),
                      calls=sum(1 for c in body if c[1].startswith("CALL")))
    return out


# the skewed work's functions in cbl_calls_build: the substep in the zone
# (the bi-Gaussian parameters at the substep's height inlined into it) and
# a fresh particle's draw (a call in every build)
CBL_SKEWED_FUNCTIONS = ("cbl_skewed_wp", "cbl_fresh_wp")
_CBL_CALLS = []


def cbl_calls_build():
    """K11's CBL part (FP_PART=2) built with FP_CBL_CALLS=1, where the
    skewed substep is a __noinline__ call as the fresh draw is: the same
    source and arithmetic, which the bound reads the skewed functions'
    instructions from (function_paths).  Never launched; built once, in
    the build phase beside the kernels."""
    from flexpart_tpu_torch import _build
    if not _CBL_CALLS:
        k = _build.ADVANCE_ADAPTIVE
        _CBL_CALLS.append(_build.Kernel(
            k.name, k.symbol, k.argtypes,
            defines=("-DFP_PART=2", "-DFP_CBL_CALLS=1")))
    return _CBL_CALLS[0]


def cbl_skewed_bound(k11, q, height, tables, a, key, cfg, itime: int,
                     settle=None) -> dict:
    """K11 CBL's bound: ``k11`` (k11_bound's on these particles) with the
    skewed work added, each call that cbl_skewed_calls counts on them
    charged the cheapest path through its function in cbl_calls_build
    (function_paths); k11_bound's own beside it."""
    paths = function_paths(cbl_calls_build(), "advance_adaptive_kernel",
                           k11_entry(cfg), CBL_SKEWED_FUNCTIONS)
    calls = cbl_skewed_calls(q, height, tables, a, key, cfg, itime, settle)
    skewed = sum(calls[f] * paths[f]["cheapest"] for f in paths)
    return dict(bound(k11["bound_bytes"], k11["bound_operations"],
                      k11["bound_instructions"] + skewed),
                bound_without_skewed_calls={
                    f: k11[f] for f in ("bound_ms", "bound_by",
                                        "bound_instructions")},
                skewed_calls=calls, skewed_paths=paths,
                skewed_instructions=skewed)


def cbl_skewed_calls(q, height, tables, a, key, cfg, itime: int,
                     settle=None) -> dict:
    """The calls of K11 CBL's skewed functions on these particles, counted
    on a run of the plain version: cbl_skewed_wp once per substep of a
    pass (ifine a pass) of a particle in the skewed zone (-h/L > CBL_ZONE)
    whose pass takes the linear form (dtf / TL_w < 0.5, the turbulence at
    the pass's start height); cbl_fresh_wp once for a fresh particle in
    the boundary layer and the zone; each computes the bi-Gaussian
    parameters once (cbl_skew, a function of its own in earlier builds of
    the kernel)."""
    import copy
    import torch
    from flexpart_tpu_torch.core import advance
    h, _, _, _, ol, _ = sample_met(q, height, tables, cfg)
    zone0 = (-h / ol) > advance.CBL_ZONE
    fresh = q.active & ((q.itramem == itime) | (itime == 0))
    n = {"cbl_skewed_wp": 0,
         "cbl_fresh_wp": int((fresh & ((q.z / h) <= 1.0) & zone0).sum())}
    inner = advance._pbl_vertical

    def counting(c, z, wp, icbt, h, ust, wst, ol, rho, drhodz, rnd_w, dtf,
                 **kw):
        # a pass's particles are those with a step left (dtf > 0)
        tlw = advance.hanna(z, h, ust, wst, ol).tlw
        lin = ((dtf > 0.0) & ((dtf / tlw) < 0.5)
               & ((-h / ol) > advance.CBL_ZONE))
        n["cbl_skewed_wp"] += int(lin.sum()) * c.ifine
        return inner(c, z, wp, icbt, h, ust, wst, ol, rho, drhodz, rnd_w,
                     dtf, **kw)

    advance._pbl_vertical = counting
    try:
        advance.advance_all_plain(q, height, tables, copy.copy(a), key, cfg,
                                  None, 0, settle)
    finally:
        advance._pbl_vertical = inner
    torch.cuda.empty_cache()
    n["cbl_skew"] = n["cbl_skewed_wp"] + n["cbl_fresh_wp"]
    return n


def sass_paths(kernel, functions, within: str = "") -> dict:
    """Instructions of a kernel's own code and of each of its named
    __noinline__ functions, read from the compiled library: each function's
    bytes from the cubin's symbol table (cuobjdump -elf), its instructions
    from cuobjdump -sass, NOPs aside.  The kernel's own code runs up to its
    first function; the toolkit's slow paths (division, reciprocal, square
    root), which run only for special inputs, are counted in none.  In a
    library of several instantiations each has its own section, its code
    followed by its own copy of each function, named after it: ``within``
    is the instantiation's mangled name, and only its section is read."""
    import re
    starts = elf_functions(kernel, within)
    sass = kernel.cuobjdump("-sass")
    if within:
        sass = "\n".join(sass_functions(sass)[within])
    code = [(int(a, 16), op) for a, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9._]*)",
        sass)]

    def count(lo, hi):
        return sum(1 for a, op in code if lo <= a < hi and op != "NOP")

    out = {"kernel": count(0, min(v for v, _ in starts.values()))}
    for f in functions:
        hit = [vs for name, vs in starts.items()
               if re.search(r"\d%sE" % f, name)]
        check(len(hit) == 1, f"{kernel.name}: function {f} not found once "
              f"in the compiled kernel: {sorted(starts)}")
        out[f] = count(hit[0][0], hit[0][0] + hit[0][1])
    return out


def k9_instructions(clwc: bool = False) -> dict:
    """sass_paths of K9's forward instantiation, or of its CLWC one (the
    BKDEP ones, the backward runs' scavenging factor, have sections of
    their own)."""
    from flexpart_tpu_torch import _build
    entry = sass_instantiation(_build.WETDEPO, "wetdepo_kernel",
                               (False, clwc))[0]
    return sass_paths(_build.WETDEPO, K9_CLWC_PATHS if clwc else K9_PATHS,
                      within=entry)


def k9_path_calls(p, zf, wet, msp, clwc: bool = False) -> dict:
    """How often K9's paths run on these inputs: the active particles it
    rains on (which read z and their cell), and per function of K9_PATHS
    (K9_CLWC_PATHS for ``clwc``) the (particle, species) that call it: a
    scavenged particle (active, raining, in or below a cloud) calls the
    rule its cell and the species select, then the removal, and in cloud
    the cloud water once."""
    import torch
    from flexpart_tpu_torch.core.interp import (horiz_weights, interp_2d,
                                                vert_weights)
    from flexpart_tpu_torch.met.fields import F2_CONVPREC, F2_LSPREC, F3_TT
    from flexpart_tpu_torch.physics import wetdepo as wd
    ny, nx = zf.f2d.shape[1:]
    lsp, convp = interp_2d(zf.f2d, (F2_LSPREC, F2_CONVPREC),
                           horiz_weights(p.x, p.y, nx, ny, False))
    ix = torch.clamp(p.x.to(torch.int32), 0, nx - 1).long()
    jy = torch.clamp(p.y.to(torch.int32), 0, ny - 1).long()
    hz = vert_weights(p.z, zf.height)[0].long()
    clouds = zf.clouds[hz, jy, ix]
    rained = p.active & ((lsp >= 0.01) | (convp >= 0.01))
    valid = rained & (clouds > 1)
    below, incl = valid & (clouds >= 4), valid & (clouds < 4)
    warm = zf.f3d[F3_TT][hz, jy, ix] >= 273.0
    n_below, n_incl = int(below.sum()), int(incl.sum())
    n_warm = int((below & warm).sum())
    calls = dict.fromkeys(K9_PATHS, 0)
    specs = wd.wet_specs(wet, msp)
    for s in range(len(wet)):
        w = specs[s]
        if w.below == 1:
            calls["lam_below_gas"] += n_below
        elif w.below == 2:
            calls["lam_below_aerosol"] += (n_warm * w.rain
                                           + (n_below - n_warm) * w.snow)
        if w.incloud:
            calls["lam_in_cloud_aerosol" if w.incloud == 1
                  else "lam_in_cloud_gas"] += n_incl
    calls["wet_removal"] = sum(v for k, v in calls.items()
                               if k.startswith("lam_"))
    if any(specs[s].incloud for s in range(len(wet))):
        calls["cloud_water"] = n_incl
    if clwc:
        calls["cloud_water_column"] = calls.pop("cloud_water")
    return dict(active_raining=int(rained.sum()), **calls)


def k9_bound(p, zf, wet, msp, instructions, clwc: bool = False) -> dict:
    """K9's (``clwc``: K9 CLWC's) least time on these inputs.  Bytes:
    positions, active, mass in and out and the deposit out of every
    particle, z of the active ones it rains on, with ``clwc`` the column
    cloud water of each one in cloud; the four surface planes, the cloud
    classes, the temperature and the heights.  Operations:
    ``instructions`` (``sass_paths``) of the kernel's own code for every
    particle and of each path's function for every call these inputs make
    (``k9_path_calls``)."""
    calls = k9_path_calls(p, zf, wet, msp, clwc)
    n, nspec = p.capacity, p.nspec
    nz, ny, nx = zf.clouds.shape
    n_bytes = (n * (17 + 12 * nspec) + 4 * calls["active_raining"]
               + 16 * ny * nx + 5 * nz * ny * nx + 4 * nz)
    if clwc:
        n_bytes += 4 * calls["cloud_water_column"]
    paths = K9_CLWC_PATHS if clwc else K9_PATHS
    n_ops = instructions["kernel"] * n + sum(
        instructions[f] * calls[f] for f in paths)
    return dict(path_calls=calls, **bound(n_bytes, n_ops))


def depo_bounds(n: int, nspec: int, zf, ccfg) -> dict:
    """K10's and K8's bounds: each input read once, each output written
    once, and their operations, counted from the sources."""
    ny, nx = zf.clouds.shape[1:]
    rows = ccfg.nage * ccfg.nclassunc * ccfg.npointspec * ccfg.nyg * ccfg.nxg
    # K10: positions, z, active in and out, mass and mass0 in, mass and the
    # deposit out; the velocity field
    k10 = bound(n * (22 + 16 * nspec) + 4 * nspec * ny * nx,
                n * (K10_OPS_PER_PARTICLE + K10_OPS_PER_SPECIES * nspec))
    # K8: positions, itramem, npoint, nclass, active, the deposit; the grid
    # read and written once (atomics on top are not counted)
    k8 = bound(n * (29 + 4 * nspec) + 2 * 4 * rows * nspec,
               n * K8_OPS_PER_PARTICLE)
    return dict(drydepo=k10, depo_scatter=k8)


def kernel_deposition(device, grid) -> dict:
    """K9, K10 and K8 against their plain versions on 10 x 2**20 particles
    over the globe, two species, on SyntheticMet's fields (the in-cloud
    rules; its clouds rain on level 1 in the storm bands) and on the same
    fields with every cloud class and a temperature across the ice ramp
    (every rule), each as drawn and in cell order (K5, the run's order),
    each timed beside its bound.  The deposit scatter takes K9's and K10's
    deposits.  Returns {"wetdepo", "drydepo", "depo_scatter"}."""
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.physics import massupdate as mu
    from flexpart_tpu_torch.physics import wetdepo as wd
    cfg, _, og, geo, ccfg = step_setup(grid)
    species = depo_species()
    wet = tuple(wd.WetSpecies.from_species(s) for s in species)
    msp = mu.MassSpecies(decay=tuple(s.decay for s in species),
                         drydep=tuple(s.drydep for s in species))
    (z0,) = met_fields("synthetic", grid, device, (3600.0,))
    fields = {"synthetic": z0, "all_classes": all_classes_met(z0, device, 21)}
    gen = torch.Generator(device=device)
    gen.manual_seed(22)
    vdep = torch.rand((len(species), grid.ny, grid.nx), generator=gen,
                      device=device) * 0.02
    p = depo_particles(N_MAIN, device, 23, grid)
    orders = {"as_drawn": p,
              "cell_ordered": reorder.reorder_by_cell_cuda(p, z0.height,
                                                           cfg)[0]}
    lage = torch.tensor([3600, 999999999], dtype=torch.int32, device=device)
    ccfg = ccfg.replace(nage=2)
    ldeltat = 2700
    k9, k10, k8, k10_tb = {}, {}, {}, {}
    deposits = {}
    k9_ops = k9_instructions()
    for oname, q in orders.items():
        for fname, zf in fields.items():
            r = check_wetdepo(q, zf, wet, msp, ldeltat,
                              f"K9 {fname}, {oname}")
            deposits[("wet", fname, oname)] = r.pop("deposit")
            r.update(k9_bound(q, zf, wet, msp, k9_ops))
            r["ms"] = cuda_ms(lambda: wd.wetdepo_cuda(
                q, zf, LSYNC, ldeltat, wet, msp), 10)
            r["plain_ms"] = cuda_ms(lambda: mu.apply_wetdepo_plain(
                q, *wd.wetscav_all_plain(q, zf, wet, False), LSYNC, ldeltat,
                msp), 3)
            k9[f"{fname}_{oname}"] = r
        r = check_drydepo(q, vdep, msp, ldeltat, f"K10 {oname}")
        deposits[("dry", oname)] = r.pop("deposit")
        r["ms"] = cuda_ms(lambda: mu.decay_drydep_cuda(
            q, vdep, LSYNC, ldeltat, msp, True), 10)
        r["plain_ms"] = cuda_ms(lambda: mu.apply_decay_drydep_plain(
            q, vdep, LSYNC, ldeltat, msp, True), 3)
        k10[oname] = r
        # the T_BELOW instantiation on the same particles: whole seconds
        # below 2 HREF of an adaptive step, 0 for the particles that
        # started above 30 m and for a third of the rest
        tb = torch.where((q.z < 30.0) & (torch.rand(
            q.capacity, generator=gen, device=device) < 2.0 / 3.0),
            torch.rand(q.capacity, generator=gen, device=device) * 900.0,
            torch.zeros_like(q.z)).trunc()
        r = check_drydepo(q, vdep, msp, ldeltat, f"K10 T_BELOW {oname}", tb)
        r.pop("deposit")
        r["ms"] = cuda_ms(lambda: mu.decay_drydep_cuda(
            q, vdep, LSYNC, ldeltat, msp, True, tb), 10)
        r["k10_ms_same_particles"] = k10[oname]["ms"]
        r["plain_ms"] = cuda_ms(lambda: mu.apply_decay_drydep_plain(
            q, vdep, LSYNC, ldeltat, msp, True, tb), 3)
        k10_tb[oname] = r
        for kind, dep in (("wet", deposits[("wet", "all_classes", oname)]),
                          ("dry", deposits[("dry", oname)])):
            k8[f"{kind}_{oname}"] = check_depo_scatter(
                q, dep, 10800, lage, ccfg, f"K8 {kind}, {oname}")
    # K8 on a plume in cell order (the run's order): sim's first release box
    q, plume_deposits = plume_particles(N_MAIN, device, 24, grid)
    q = reorder.reorder_by_cell_cuda(q, z0.height, cfg)[0]
    for kind, dep in plume_deposits.items():
        k8[kind] = check_depo_scatter(q, dep, 10800, lage, ccfg, f"K8 {kind}")
    del q, plume_deposits
    # every rule scavenged somewhere: both species on the cloud classes of
    # SyntheticMet (in cloud) and on every class (below cloud too)
    for name, r in k9.items():
        check(min(r["scavenged_share"]) > 0.0,
              f"K9 {name}: a species scavenged nothing: {r['scavenged_share']}")
    for name, r in k10.items():
        check(r["ended_by_minmass"] > 0 and r["depositing_share"] > 0.1,
              f"K10 {name}: {r['ended_by_minmass']} ended, "
              f"{r['depositing_share']} depositing")
    del deposits, orders, p
    bounds = depo_bounds(N_MAIN, len(species), z0, ccfg)
    k9_main = k9["synthetic_cell_ordered"]
    bounds["wetdepo"] = {f: k9_main[f] for f in (
        "bound_ms", "bound_by", "bound_bytes", "bound_operations")}
    out = {}
    for name, cases, main in (("wetdepo", k9, "synthetic_cell_ordered"),
                              ("drydepo", k10, "cell_ordered"),
                              ("depo_scatter", k8, "dry_cell_ordered")):
        m = cases[main]
        out[name] = dict(
            max_abs_err=max(c["max_abs_err"] for c in cases.values()),
            ms=m["ms"], plain_ms=m["plain_ms"],
            library_ms=m.get("library_ms"),
            ms_case=main, cases=cases, **bounds[name])
        if name != "depo_scatter":
            out[name]["bitwise"] = all(c["bitwise"] for c in cases.values())
            out[name]["values_differ"] = sum(c["values_differ"]
                                             for c in cases.values())
    out["wetdepo"]["instructions"] = k9_ops
    # K10 T_BELOW: K10's bytes and 4 B of t_below per particle; its
    # operations K10's (every depositing particle gathers its velocity)
    m = k10_tb["cell_ordered"]
    out["drydepo"]["t_below"] = dict(
        ms=m["ms"], plain_ms=m["plain_ms"],
        k10_ms_same_particles=m["k10_ms_same_particles"],
        unordered_ms=k10_tb["as_drawn"]["ms"], library_ms=None,
        bitwise=all(c["bitwise"] for c in k10_tb.values()),
        values_differ=sum(c["values_differ"] for c in k10_tb.values()),
        max_abs_err=max(c["max_abs_err"] for c in k10_tb.values()),
        **bound(bounds["drydepo"]["bound_bytes"] + 4 * N_MAIN,
                bounds["drydepo"]["bound_operations"]))
    torch.cuda.empty_cache()
    return out


def storm_band_particles(p, zf, device):
    """The step's particles put where SyntheticMet rains from a cloud on
    level 1 (class 2 or 3, large-scale or convective rate at least 0.01),
    slot s in the s-th such cell, round robin, halfway between levels 1
    and 2, all active: the wet-deposition kernel's in-cloud rules must
    scavenge them."""
    import torch
    from flexpart_tpu_torch.met.fields import F2_CONVPREC, F2_LSPREC
    ny, nx = zf.clouds.shape[1:]
    rain = (zf.f2d[F2_LSPREC] >= 0.01) | (zf.f2d[F2_CONVPREC] >= 0.01)
    cells = torch.nonzero((zf.clouds[1] > 1) & rain
                          & (torch.arange(nx, device=device) < nx - 1)
                          & (torch.arange(ny, device=device)[:, None]
                             < ny - 1))
    check(cells.shape[0] > 0, "no cell rains from a cloud on level 1")
    n = p.capacity
    at = cells[torch.arange(n, device=device) % cells.shape[0]]
    zero = torch.zeros_like(p.x_lo)
    zmid = 0.5 * (zf.height[1] + zf.height[2])
    return p.replace(x_hi=at[:, 1].float() + 0.5, x_lo=zero,
                     y_hi=at[:, 0].float() + 0.5, y_lo=zero,
                     z=torch.full_like(p.z, float(zmid)),
                     active=torch.ones_like(p.active))


def sim_depo_checks(sim, snap, what: str) -> dict:
    """K9, K10 and K8 against their plain versions on one kept step of
    ``Simulation.run``: the step's particles (after its release, before
    its sort), its met field nearest itime - lsync/2 (K9) and its later
    field's deposition velocities (K10), its ldeltat; lsync and the times
    signed as the run's, negative backward.  K8 on both deposits, the wet
    one at itime and the dry one at itime + lsync, against the float64 sum
    of its pairs: forward only (a backward run grids no deposit).  Where
    fewer than SIM_MIN_RAINED of the active particles are scavenged, K9
    once more on them put in the storm band (``storm_band_particles``),
    where it must scavenge."""
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.physics import massupdate as mu
    from flexpart_tpu_torch.physics import wetdepo as wd
    istep, itime, p, z0, z1, mt0, mt1 = snap[:7]
    ld = sim.cmd.ldirect
    # the run's output time and ldeltat (hourly output), mirrored forward
    t = ld * itime
    loutnext = 3600 * max(1, -(-t // 3600))
    ldeltat = ld * (t - (loutnext - 3600))
    interp_t = itime - ld * LSYNC // 2
    zw = z0 if abs(mt0 - interp_t) < abs(mt1 - interp_t) else z1
    wet, msp = sim.wet_species, sim.mass_species
    res = {}
    r9 = check_wetdepo(p, zw, wet, msp, ldeltat, f"{what}: K9")
    wdep = r9.pop("deposit")
    r9.update(k9_bound(p, zw, wet, msp, k9_instructions()))
    r9["ms"] = cuda_ms(lambda: wd.wetdepo_cuda(p, zw, LSYNC, ldeltat, wet,
                                               msp), 10)
    r9["plain_ms"] = cuda_ms(lambda: mu.apply_wetdepo_plain(
        p, *wd.wetscav_all_plain(p, zw, wet, False), LSYNC, ldeltat, msp), 3)
    rained = max(r9["scavenged_share"])
    if rained < SIM_MIN_RAINED:
        q = storm_band_particles(p, zw, sim.device)
        r9["in_the_storm_band"] = s = check_wetdepo(
            q, zw, wet, msp, ldeltat, f"{what}: K9 in the storm band")
        s.pop("deposit")
        check(max(s["scavenged_share"]) > SIM_MIN_RAINED,
              f"{what}: K9 scavenged nothing in the storm band")
    res["wetdepo"] = r9
    r10 = check_drydepo(p, z1.vdep, msp, ldeltat, f"{what}: K10")
    ddep = r10.pop("deposit")
    r10["ms"] = cuda_ms(lambda: mu.decay_drydep_cuda(
        p, z1.vdep, LSYNC, ldeltat, msp, True), 10)
    r10["plain_ms"] = cuda_ms(lambda: mu.apply_decay_drydep_plain(
        p, z1.vdep, LSYNC, ldeltat, msp, True), 3)
    res["drydepo"] = r10
    if ld == 1:
        res["depo_scatter"] = {
            "wet": check_depo_scatter(p, wdep, itime, sim.lage,
                                      sim.conc_cfg, f"{what}: K8 wet"),
            "dry": check_depo_scatter(p, ddep, itime + LSYNC, sim.lage,
                                      sim.conc_cfg, f"{what}: K8 dry")}
    return res


def check_sorted(p, q, perm, height, cfg, what: str) -> None:
    """The cell-order sort's contract: ``perm`` is the stable argsort of the
    cell keys, bitwise (so it names every slot once, the keys of ``q`` never
    decrease, equal keys keep their slot order and the particles that are
    not scheduled come last), and every field of ``q`` is ``p[perm]``
    bitwise."""
    import torch
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.core.state import FIELDS
    n = p.capacity
    check(perm.shape == (n,) and perm.dtype == torch.int32,
          f"{what}: perm is {perm.dtype} {tuple(perm.shape)}")
    want = torch.argsort(reorder.cell_keys(p, height, cfg), stable=True)
    differ = int((perm.long() != want).sum())
    check(differ == 0, f"{what}: perm differs from the stable argsort of the "
          f"keys in {differ} of {n} slots")
    check_same_bits(q, reorder.apply_perm(p, want), f"{what}: out vs in[perm]",
                    FIELDS)
    n_on = int(p.active.sum())
    check(bool(q.active[:n_on].all()) and not bool(q.active[n_on:].any()),
          f"{what}: unscheduled particles are not last")


def release_step_particles(n: int, n_fresh: int, device, seed: int):
    """What the sort meets on a release step: ``n_fresh`` particles just
    woken inside a 2 x 2 degree box, in the last slots (a schedule is built
    in box order), and every other slot not scheduled yet."""
    import torch
    p = bench_particles(n, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 2)

    def u(lo, hi):
        return torch.rand(n_fresh, generator=gen, device=device) * (hi - lo) + lo

    x, y, z = p.x_hi.clone(), p.y_hi.clone(), p.z.clone()
    x[n - n_fresh:] = u(180.0, 182.0)
    y[n - n_fresh:] = u(130.0, 132.0)
    z[n - n_fresh:] = u(50.0, 500.0)
    active = torch.zeros_like(p.active)
    active[n - n_fresh:] = True
    return p.replace(x_hi=x, y_hi=y, z=z, active=active)


def kernel_reorder(device, grid) -> dict:
    """K5 against its plain version on the card.  At one 2**19 chunk of
    edge_particles (1/64 not scheduled): K4 on K5's output with the injected
    draws permuted alike must equal K4 on the unordered input, permuted,
    bitwise.  At the main path's shape, on four inputs (the shuffled
    ensemble; the main path's, REORDER_EVERY steps after a sort; every slot
    unscheduled; a release step): ``perm`` must equal the stable argsort of
    the keys and every field the plain version's, bitwise, and a second
    launch must give the same ``perm``; each input is timed beside the
    plain version, ``torch.argsort`` of its keys, and its bound."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.core.state import FIELDS
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem1 = 3600, 10800
    cfg, prm, *_ = step_setup(grid)
    tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    key = rng.Key(4321, 4)
    height = z0.height

    def k4(p, draws=None, k=key):
        return advance.advance_all_cuda(p, height, tables, a, k, cfg, draws, 0)[0]

    p = edge_particles(CHUNK, device, 21, itime, lambda q: sample_met(
        q, height, tables, cfg)[0])
    q, perm = reorder.reorder_by_cell_cuda(p, height, cfg)
    torch.cuda.synchronize()
    check_sorted(p, q, perm, height, cfg, "K5 edge particles")
    draws = {tag: rng.normals(key, (rows, CHUNK), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}
    idx = perm.long()
    draws_q = {t: d[:, idx].contiguous() for t, d in draws.items()}
    check_same_bits(k4(q, draws_q), reorder.apply_perm(k4(p, draws), perm),
                    "K4 on K5's output vs K4 on the unordered input, permuted")
    n_unscheduled = int((~p.active).sum())
    del p, q, draws, draws_q
    torch.cuda.empty_cache()

    # every field read once and written once, perm written; the pairs and
    # the digit counts are scratch.  On a shuffled ensemble every field of a
    # particle comes from a 32 B sector of its own.
    shuffled = bench_particles(N_MAIN, device, seed=3, old_fraction=1.0)
    widths = [getattr(shuffled, f)[0].numel() * getattr(shuffled, f).element_size()
              for f in FIELDS]
    n_bytes = (2 * sum(widths) + 4) * N_MAIN + 4 * grid.nlev
    sector_bytes = (sum(32 * -(-w // 32) for w in widths) + sum(widths) + 4) \
        * N_MAIN
    ordered = reorder.reorder_by_cell_cuda(shuffled, height, cfg)[0]
    for s in range(reorder.REORDER_EVERY):
        ordered = k4(ordered, k=rng.Key(4321, 10 + s))
    inputs = {
        "shuffled": shuffled,
        "ordered": ordered,
        "all_unscheduled": shuffled.replace(
            active=torch.zeros_like(shuffled.active)),
        "release_step": release_step_particles(N_MAIN, N_STEP4, device, 3),
    }
    del shuffled, ordered
    cases = {}
    for name, p in inputs.items():
        what = f"K5 at the main path's shape, {name}"
        q, perm = reorder.reorder_by_cell_cuda(p, height, cfg)
        check_sorted(p, q, perm, height, cfg, what)
        q_plain, perm_plain = reorder.reorder_by_cell_plain(p, height, cfg)
        check(torch.equal(perm, perm_plain), f"{what}: perm vs the plain version's")
        check_same_bits(q, q_plain, f"{what}: fields vs the plain version's",
                        FIELDS)
        del q, q_plain, perm_plain
        check(torch.equal(reorder.reorder_by_cell_cuda(p, height, cfg)[1], perm),
              f"{what}: two launches give different perms")
        keys = reorder.cell_keys(p, height, cfg)
        cases[name] = dict(
            scheduled=int(p.active.sum()),
            occupied_bins=int(torch.unique(keys).numel()),
            slots_moved_share=float((perm != torch.arange(
                N_MAIN, dtype=torch.int32, device=device)).float().mean()),
            ms=cuda_ms(lambda: reorder.reorder_by_cell_cuda(p, height, cfg), 5),
            plain_ms=cuda_ms(lambda: reorder.reorder_by_cell_plain(
                p, height, cfg), 2),
            library_ms=cuda_ms(lambda: torch.argsort(keys, stable=True), 3),
            **bound(n_bytes, K5_OPS_PER_PARTICLE * N_MAIN))
        del keys, perm
        torch.cuda.empty_cache()
    cases["shuffled"]["sector_bound_ms"] = sector_bytes / HBM_BYTES_PER_S * 1e3
    steady = cases["ordered"]
    return dict(
        max_abs_err=0.0, n=N_MAIN, steps_after_sort=reorder.REORDER_EVERY,
        edge_unscheduled=n_unscheduled, cases=cases,
        **{f: steady[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "bound_bytes",
                                  "bound_operations", "slots_moved_share")},
        shuffled_ms=cases["shuffled"]["ms"])


def phase_reorder(device, grid) -> dict:
    """What the cell order is worth and how fast it decays.  On SyntheticMet
    and on the main path's uniform wind: K4 and K3 (4-point path) on the
    unordered bench ensemble, then right after a sort and after each of
    DECAY_STEPS further steps, K5 on the shuffled ensemble and 0 and each of
    SORT_INTERVALS steps after a sort; from these the device time of K4 +
    K3 + K5 per step for a sort every 1, 2, ... 64 steps."""
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, prm, og, geo, ccfg = step_setup(grid)
    ccfg = ccfg.replace(kernel_possible=True)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    flat = zero_accumulators(geo, 1, 1, device=device).gridunc.view(-1, 1)
    itime = 3600
    res = {"reorder_every": reorder.REORDER_EVERY}
    for kind in ("synthetic", "uniform"):
        if kind == "synthetic":
            z0, z1 = met_fields(kind, grid, device, (0.0, 10800.0))
            mem1 = 10800
        else:
            (z0,) = met_fields(kind, grid, device)
            z1, mem1 = z0, 86400
        tw = advance._time_weights(itime, 0, mem1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(z0, z1, *tw,
                                               dtype=cfg.table_dtype)
        a = advance.advance_args(cfg, prm, itime, 0, mem1)
        height = z0.height

        def k4(p, s=0):
            return advance.advance_all_cuda(p, height, tables, a,
                                            rng.Key(55, s), cfg, None, 0)[0]

        def k3_ms(p):
            return cuda_ms(lambda: cc.conccalc_cuda(
                flat, p, itime + LSYNC, lage, oh, 1.0, None, ccfg), 5)

        def k5_ms(p):
            return cuda_ms(lambda: reorder.reorder_by_cell_cuda(
                p, height, cfg), 3)

        # one step first: the particles are old enough for the 4-point path
        p = k4(bench_particles(N_MAIN, device, seed=3, old_fraction=1.0), 99)
        out = dict(k4_unordered_ms=cuda_ms(lambda: k4(p), 5),
                   k3_unordered_ms=k3_ms(p), k5_shuffled_ms=k5_ms(p),
                   k4_ms=[], k3_ms=[], k5_ms={})
        p, _ = reorder.reorder_by_cell_cuda(p, height, cfg)
        for s in range(DECAY_STEPS + 1):
            out["k4_ms"].append(cuda_ms(lambda: k4(p), 5))
            out["k3_ms"].append(k3_ms(p))
            if s in (0,) + SORT_INTERVALS:
                out["k5_ms"][str(s)] = k5_ms(p)
            p = k4(p, s)
        out["unordered_ms_per_step"] = (out["k4_unordered_ms"]
                                        + out["k3_unordered_ms"])
        out["ms_per_step_if_sorted_every"] = {
            str(e): (sum(out["k4_ms"][:e]) + sum(out["k3_ms"][:e])
                     + out["k5_ms"][str(e)]) / e for e in SORT_INTERVALS}
        res[kind] = out
        del p, tables, z0, z1
        torch.cuda.empty_cache()
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

    # plain twins: the chunk loop with the twin tables and twin sampling
    tw0, tw1, ew0, ew1, _ = advance._time_weights(itime, 0, mem1, prm, cfg)
    tables = interp.quad_tables_plain(z0.f3d, z1.f3d, z0.f2d, z1.f2d, tw0,
                                      tw1, ew0, ew1, cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, 0, mem1)
    parts = []
    for c in range(n_chunks):
        lo, hi = c * CHUNK, (c + 1) * CHUNK
        q, _ = advance.advance_all_plain(
            p.rows(lo, hi), z0.height, tables, a, key, cfg,
            {t: v[:, lo:hi] for t, v in draws.items()}, lo)
        parts.append(q)
    pp = Particles.cat(parts)
    gp = zero_accumulators(geo, 1, 1, device=device).gridunc
    cc.conccalc_plain(gp.view(-1, 1), pp, itime + LSYNC, lage, oh, 1.0, None,
                      ccfg)

    res = compare_particles(pk, pp, "step", float(grid.nx - 1))
    check(int(dk.n_active) == n and int(dk.nan_count) == 0, "step: lost particles")
    gd = (gk - gp).abs()
    check(bool(torch.all(gd <= K3_RTOL * gp.abs())), "step: gridunc differs")
    check(abs(float(gk.sum()) - 1.0) < 1e-3, f"step: sampled mass {float(gk.sum())}")

    # the device function against K1: K4 drawing in registers gives bitwise
    # the particles of K4 fed rng.normals' draws for the same key
    p_reg, _ = advance.advance_chunked(p, z0, z1, itime, 0, mem1, key, cfg,
                                       prm, n_chunks)
    check_same_bits(p_reg, pk, "step: draws in registers vs the normals kernel's")
    return dict(n=n, **res, in_register_draws_bitwise=True,
                gridunc_max_abs_err=float(gd.max()), mass=float(gk.sum()))


def counted_run(kernels, run):
    """``run()`` with every launch count set to 0 just before it and read
    just after, the card idle both times: (the launches by kernel, the
    seconds it took)."""
    import torch
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return {k.name: k.launches for k in kernels}, time.perf_counter() - t0


def phase_main(device, grid, kernels) -> tuple[dict, dict]:
    """The bench.py step at full width, MAIN_STEPS steps with a sort every
    REORDER_EVERY; launch counts reset just
    before and read just after.  Then the profile of two more steps.
    Returns (main, profile)."""
    import torch
    from flexpart_tpu_torch.core import advance, reorder, rng
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, prm, og, geo, ccfg = step_setup(grid)
    every = reorder.REORDER_EVERY
    (z0,) = met_fields("uniform", grid, device)
    p = bench_particles(N_MAIN, device, seed=0)
    conc = cc.make_conccalc(og.outheights)
    acc = zero_accumulators(geo, 1, 1, device=device)
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    n_chunks = max(1, N_MAIN // CHUNK)
    finite = torch.ones((), dtype=torch.bool, device=device)
    diags, step_s = [], []

    def one_step(i: int):
        nonlocal p, acc
        it = i * LSYNC
        if i % every == 0:
            p, _ = reorder.reorder_by_cell(p, z0.height, cfg)
        p, diag = advance.advance_chunked(p, z0, z0, it, 0, 86400,
                                          rng.Key(2, i), cfg, prm, n_chunks)
        c = ccfg.replace(kernel_possible=cc.kernel_possible_at(it + LSYNC, 0))
        acc = conc(acc, p, z0, it + LSYNC, lage, 1.0, c)
        return diag

    def steps():
        nonlocal finite
        for i in range(MAIN_STEPS):
            t0 = time.perf_counter()
            diag = one_step(i)
            finite &= (torch.isfinite(p.x).all() & torch.isfinite(p.y).all()
                       & torch.isfinite(p.z).all())
            diags.append(diag)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)

    launches, wall = counted_run(kernels, steps)

    for i, d in enumerate(diags):
        check(int(d.n_active) == N_MAIN, f"main step {i}: n_active {int(d.n_active)}")
        check(int(d.nan_count) == 0, f"main step {i}: nan_count {int(d.nan_count)}")
    check(bool(finite), "main: non-finite positions")
    total = float(acc.gridunc.sum(dtype=torch.float64))
    check(abs(total - MAIN_STEPS) <= 1e-3 * MAIN_STEPS,
          f"main: sampled mass {total} != {MAIN_STEPS}")
    # the draws of the main path are made inside the advance kernel; the
    # stand-alone normals kernel is launched by the other phases
    for name in ("advance", "quad_tables", "conccalc", "reorder"):
        check(launches[name] > 0, f"main: kernel {name} was never launched")
    check(launches["reorder"] == len(range(0, MAIN_STEPS, every)),
          f"main: {launches['reorder']} sorts in {MAIN_STEPS} steps")
    steady = step_s[1:]
    rate = N_MAIN * len(steady) / sum(steady)
    res = dict(n=N_MAIN, steps=MAIN_STEPS, n_chunks=n_chunks,
               advance_launches_per_step=launches["advance"] / MAIN_STEPS,
               reorder_every=every,
               steady_steps_with_a_sort=len(range(every, MAIN_STEPS, every)),
               wall_s=wall, first_step_s=step_s[0],
               steady_step_s=sum(steady) / len(steady),
               steady_step_min_s=min(steady), steady_step_max_s=max(steady),
               particle_steps_per_s=rate, sampled_mass=total,
               kernel_steps=sum(cc.kernel_possible_at(i * LSYNC + LSYNC, 0)
                                for i in range(MAIN_STEPS)),
               launches=launches)

    def steps(first: int, count: int):
        for i in range(first, first + count):
            one_step(i)
        torch.cuda.synchronize()

    # a window of `every` steps holds exactly one sort
    return res, profile_steps(steps, MAIN_STEPS, every)


# the device functions of csrc/reorder.cu, as the profiler names them
SORT_KERNELS = ("key_kernel", "digit_count_kernel", "scan_tile_sums_kernel",
                "scan_sums_kernel", "scan_tiles_kernel", "scatter_kernel",
                "gather_kernel")


def device_rows(prof) -> list:
    """(kernel name, launches, device ms) of a torch.profiler profile, the
    device-side rows only, longest first."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    return rows


def profile_steps(steps, first: int, count: int) -> dict:
    """``count`` more steady steps under torch.profiler: CUDA kernels per
    step, device time by kernel (the sort's kernels also summed) and the
    share of the window the card was busy."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps(first, count)
    t0 = time.perf_counter()
    steps(first + count, count)
    unprofiled = time.perf_counter() - t0
    rows = device_rows(prof)
    device_ms = sum(r[2] for r in rows)
    sort = [r for r in rows if any(w in r[0] for w in SORT_KERNELS)]
    return dict(steps=count, unprofiled_step_s=unprofiled / count,
                cuda_kernels_per_step=sum(r[1] for r in rows) / count,
                device_ms_per_step=device_ms / count,
                device_busy_share=device_ms / 1e3 / unprofiled,
                sort_kernels_per_step=sum(r[1] for r in sort) / count,
                sort_ms_per_step=sum(r[2] for r in sort) / count,
                top=[dict(name=k[:60], calls=c / count, ms=ms / count)
                     for k, c, ms in rows[:12]])



# ------------------------------------------------------------ Simulation --

SIM_GRID = BENCH_GRID      # global, to the poles: the polar caps are on
SIM_HOURS = 3
SIM_DIR = ROOT / "build" / "sim_smoke"
# the second box of the sim phase, in SyntheticMet's storm band, where the
# clouds of level 1 rain (the first box's plume at 40-42 N meets no cloud)
N_STORM = 2 ** 20
STORM_BOX = dict(lon1=28.0, lon2=30.0, lat1=50.0, lat2=52.0)


def sim_species():
    """The sim phase's species: the default tracer, and a Cs-137-like
    aerosol without settling (no density): below-cloud rain and snow
    efficiencies, in-cloud CCN and IN efficiencies, a constant dry
    velocity of 1 mm/s and Cs-137's half-life of 30.17 years."""
    from flexpart_tpu_torch.config import Species
    return (Species(),
            Species(name="CS-137", decay_halflife=30.17 * 365.25 * 86400.0,
                    crain_aero=1.0, csnow_aero=1.0, ccn_aero=0.9,
                    in_aero=0.1, dquer=0.4, dryvel=1.0e-3))


def sim_config():
    """The sim phase's configuration: the default Command over SIM_HOURS
    hours from 2020-01-01 00:00 with hourly output, two release boxes over
    the first hour (sim_setup), the 0.5-degree, 3-layer output grid.
    Returns (Command, Releases, OutGrid)."""
    from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox,
                                           Releases)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=SIM_HOURS * 10000, lsynctime=LSYNC, loutstep=3600,
                  loutaver=3600, loutsample=900)
    when = dict(idate1=20200101, itime1=0, idate2=20200101, itime2=10000,
                z1=50.0, z2=500.0)
    boxes = (ReleaseBox(lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0,
                        mass=(1.0, 1.0), parts=N_MAIN - N_STORM, **when),
             ReleaseBox(**STORM_BOX, mass=(0.0, 1.0), parts=N_STORM, **when))
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720, numygrid=360,
                 dxout=0.5, dyout=0.5, outheights=(100.0, 1000.0, 50000.0))
    return cmd, Releases(species=sim_species(), boxes=boxes), og


def sim_setup(outdir, device, write_netcdf: bool, **kw):
    """The port's Simulation at full width with the default Command
    (convection and subgrid orography on): 10 x 2**20 particles released
    over the first hour from a 2 x 2 degree box at 40-42 N (both species,
    one unit of mass each; N_MAIN - N_STORM particles) and from a second
    one in the storm band (STORM_BOX: the Cs-137-like species only, one
    unit; N_STORM particles), three hours of 900 s steps on SyntheticMet,
    on the main phase's global 1-degree grid, which reaches the poles (the
    advance takes its polar-cap update), hourly output on the main
    phase's 0.5-degree, 3-layer grid, one output per release box."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    grid = make_grid(**SIM_GRID)
    cmd, releases, og = sim_config()
    return Simulation(cmd=cmd, releases=releases, grid=grid,
                      met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), device=device,
                      write_netcdf=write_netcdf, **kw)


def on_convecting_columns(p, conv, grid, itime: int, what: str,
                          every_level: bool = False):
    """``p`` with slot s put at the centre of the s-th convecting column
    of ``conv`` (round robin), every slot scheduled and released at
    ``itime``: where K7 must move particles.  z kept, or with
    ``every_level`` the middle of level (s // columns) mod L1 of its
    column: backward, K7 moves a particle only where its level's mass came
    from other levels (the updraft's detrainment levels, a downdraft's
    base), which the low plume never reaches."""
    import torch
    cols = torch.nonzero(conv.lconv).flatten().to(torch.int32)
    check(cols.numel() > 0, f"{what}: no column convects")
    slot = torch.arange(p.capacity, device=cols.device)
    at = cols[slot % cols.numel()]
    z = p.z
    if every_level:
        L1 = conv.uvzlev.shape[1] - 1
        lev = (slot // cols.numel()) % L1
        uvz = conv.uvzlev[at.long()]
        z = 0.5 * (uvz.gather(1, lev[:, None]) + uvz.gather(1, lev[:, None]
                                                             + 1))[:, 0]
    zero = torch.zeros_like(p.x_lo)
    return p.replace(x_hi=(at % grid.nx).float(), x_lo=zero,
                     y_hi=(at // grid.nx).float(), y_lo=zero,
                     z=z.contiguous(), itra=torch.full_like(p.itra, itime),
                     active=torch.ones_like(p.active))


def sim_conccalc_checks(sim, q, z1, itime: int, what: str) -> dict:
    """K3 against its plain version on the particles ``q`` that one step
    of ``Simulation.run`` samples, on the step's own path and on the
    4-point path, both held to the float64 sum of the same pairs."""
    import torch
    from flexpart_tpu_torch.grid import conccalc as cc
    device = sim.device
    step_ccfg = sim._ccfg_at(itime, sim.conc_cfg)
    oh = torch.tensor(sim.outgrid.outheights, dtype=torch.float32,
                      device=device)
    rhoi = cc._rho_at_particles(q, z1) if step_ccfg.ind_samp == -1 else None
    gk = torch.zeros_like(sim.acc.gridunc)
    gp = torch.zeros_like(gk)
    flat_k, flat_p = gk.view(-1, q.nspec), gp.view(-1, q.nspec)
    res = {}
    for kp in sorted({step_ccfg.kernel_possible, True}):
        c = step_ccfg.replace(kernel_possible=kp)
        args = (q, itime, sim.lage, oh, 1.0, rhoi, c)
        path = "4-point" if kp else "single-index"
        gk.zero_()
        gp.zero_()
        cc.conccalc_cuda(flat_k, *args)
        cc.conccalc_plain(flat_p, *args)
        # A plume puts up to 10**6 equal contributions into one output
        # cell, and float32 additions in different orders then differ by
        # more than the kernels phase's rtol (the plain version's
        # index_add_ adds them one by one).  So both are held to the
        # float64 sum of the same pairs: any order of m float32 additions
        # of non-negative terms stays within m * 2**-24 of it, relatively,
        # and a cell of few pairs is held as tightly as in the kernels phase.
        lin, valid, contrib = cc.conccalc_pairs(flat_k.shape[0], *args)
        lin, contrib = lin[valid], contrib[valid]
        flat_l = torch.zeros_like(flat_k)
        library_ms = cuda_ms(lambda: flat_l.index_add_(0, lin, contrib), 10)
        del flat_l
        ref = torch.zeros(flat_k.shape, dtype=torch.float64, device=device)
        ref.index_add_(0, lin, contrib.double())
        pairs = torch.zeros(flat_k.shape[0], dtype=torch.int64, device=device)
        pairs.index_add_(0, lin, torch.ones_like(lin))
        del lin, valid, contrib
        rtol = torch.clamp(pairs.double() * 2.0 ** -24, min=K3_RTOL)[:, None]
        check(float(ref.sum()) > 0.0, f"{what}: K3 {path} samples nothing")
        rel = {}
        for who, flat in (("kernel", flat_k), ("plain", flat_p)):
            d = (flat.double() - ref).abs()
            rel[who] = float((d / ref.clamp(min=1e-300)).max())
            check(bool(torch.all(d <= rtol * ref)),
                  f"{what}: K3 {path} path, {who}: a cell is further from "
                  f"the float64 sum of its pairs than their count allows, "
                  f"max rel {rel[who]}")
        res[path] = dict(
            the_steps_own_path=kp == step_ccfg.kernel_possible,
            max_abs_err=float((flat_k.double() - ref).abs().max()),
            max_rel_err_vs_f64=rel["kernel"],
            plain_max_rel_err_vs_f64=rel["plain"],
            total_rel_err_vs_f64=abs(float(flat_k.sum(dtype=torch.float64))
                                     / float(ref.sum()) - 1.0),
            cells_hit=int((pairs != 0).sum()),
            most_pairs_in_a_cell=int(pairs.max()),
            ms=cuda_ms(lambda: cc.conccalc_cuda(flat_k, *args), 10),
            plain_ms=cuda_ms(lambda: cc.conccalc_plain(flat_p, *args), 3),
            library_ms=library_ms)
        del ref, pairs, rtol, d
    return res


def sim_backward_kernel_checks(sim, snap, what: str) -> dict:
    """The kernels of a backward run's step against their plain versions
    on the tensors that one step of ``Simulation.run`` gave them (``snap``
    as in sim_kernel_checks): K9 and K10 (sim_depo_checks: no deposit is
    gridded backward); on the particles in the step's cell order, K6 at
    the step's time weights and flux memory, bitwise, and K7 BACKWARD with
    the step's key, z bitwise and the moved counts equal, with injected
    uniforms and with its own; once more on those particles put in the
    step's convecting columns at every level, where some must move; then
    K3 on the redistributed particles (sim_conccalc_checks)."""
    import numpy as np
    import torch
    from flexpart_tpu_torch.core import reorder, rng
    from flexpart_tpu_torch.physics import convection as cv
    istep, itime, p, z0, z1, mt0, mt1, eta0, eta1, cbmf = snap
    ld = sim.cmd.ldirect
    check(ld == -1, f"{what}: not a backward run")
    n, grid = p.capacity, sim.grid
    res = dict(istep=istep, itime=itime, scheduled=int(p.active.sum()))
    res.update(sim_depo_checks(sim, snap, what))
    q = reorder.reorder_by_cell_cuda(p, z0.height, sim.step_cfg)[0]
    kern = sim.conv_kernel
    fields = tuple(getattr(e, name) for e in (eta0, eta1)
                   for name in ("ps", "tth", "qvh", "tt2", "td2"))
    dt1, dt2 = float(itime - mt0), float(mt1 - itime)
    dtt = 1.0 / (dt1 + dt2)
    tw = (float(np.float32(dt2 * dtt)), float(np.float32(dt1 * dtt)))
    conv, _, res["convection"] = check_convection(kern, fields, cbmf,
                                                  f"{what}:", tw)
    key = rng.Key(sim.seed, istep)
    own = rng.uniforms_plain(n, *key.philox_key(cv.REDIST_TAG), sim.device)
    k7 = {draw: check_redist(q, key, conv, kern, grid, rn,
                             f"{what}: K7 BACKWARD, {draw} uniforms", itime,
                             ldirect=ld)
          for draw, rn in (("injected", own), ("in_registers", None))}
    q_live = on_convecting_columns(q, conv, grid, itime, f"{what}: K7",
                                   every_level=True)
    live = check_redist(q_live, key, conv, kern, grid, None,
                        f"{what}: K7 BACKWARD on convecting columns", itime,
                        ldirect=ld)
    check(live["moved"] > 0, f"{what}: K7 BACKWARD moved no particle of "
          "the step's convecting columns")
    args7 = redist_args(conv, kern, grid, itime)
    res["redist_backward"] = dict(
        **k7, **k7_bound(q, conv, kern, grid, itime),
        on_convecting_columns=dict(
            **live, **k7_bound(q_live, conv, kern, grid, itime)))
    del q_live
    q = cv.redist_cuda(q, key, *args7, ldirect=ld)[0]
    del conv, fields
    res["conccalc"] = sim_conccalc_checks(sim, q, z1, itime, what)
    torch.cuda.empty_cache()
    return res


def sim_kernel_checks(sim, snap, what: str) -> dict:
    """K9, K10, K8, K2, K5, K6, K7, K3 and K4 against their plain versions
    on the tensors that one step of ``Simulation.run`` gave them: ``snap``
    is (istep, itime, particles after the step's release and before its
    sort, z0, z1, mt0, mt1, the raw fields of both met times, the flux
    memory cbmf) as the step probe saw them.  First the deposition kernels
    (``sim_depo_checks``); then, in the step's order: the tables
    of its time weights, the sort, the convection columns of its time
    weights, the redistribution of the sorted particles with the step's
    key (injected uniforms, and once more its own, which must give the
    same particles; and with those particles put in the step's convecting
    columns, where some must move), then on the redistributed particles
    the sampling (the
    step's own path and the 4-point path) and the advance with the step's
    key, fed injected draws on both sides and once more with its draws made
    in registers.  Tolerances as in the kernels phase, but for the
    sampling, which is held to the float64 sum of its pairs; every check
    is fatal."""
    import numpy as np
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.core.state import FIELDS
    from flexpart_tpu_torch.physics import convection as cv
    istep, itime, p, z0, z1, mt0, mt1, eta0, eta1, cbmf = snap
    cfg, prm, device = sim.step_cfg, sim.step_prm, sim.device
    height = z0.height
    n = p.capacity
    res = dict(istep=istep, itime=itime, scheduled=int(p.active.sum()),
               occupied_met_cells=unique_rows(p, height, cfg))
    # the deposition kernels first: the step's wet pass comes before its
    # release and sort (the particles woken by the release are live here)
    res.update(sim_depo_checks(sim, snap, what))

    # K2: bitwise
    tw = advance._time_weights(itime, mt0, mt1, prm, cfg)[:4]
    targs = (z0.f3d, z1.f3d, z0.f2d, z1.f2d, *tw, cfg.table_dtype)
    tk = interp.quad_tables_cuda(*targs)
    tp = interp.quad_tables_plain(*targs)
    bits = torch.int16 if cfg.table_dtype == torch.bfloat16 else torch.int32
    for name in ("rows", "rowsE"):
        x, y = getattr(tk, name), getattr(tp, name)
        differ = int((x.view(bits) != y.view(bits)).sum())
        check(x.shape == y.shape and differ == 0,
              f"{what}: K2 {name} differs from the plain version in "
              f"{differ} values")
    res["quad_tables"] = dict(
        max_abs_err=0.0, ms=cuda_ms(lambda: interp.quad_tables_cuda(*targs), 10),
        plain_ms=cuda_ms(lambda: interp.quad_tables_plain(*targs), 3))

    # K5: perm and every field bitwise, twice
    q, perm = reorder.reorder_by_cell_cuda(p, height, cfg)
    check_sorted(p, q, perm, height, cfg, f"{what}: K5")
    q_plain, perm_plain = reorder.reorder_by_cell_plain(p, height, cfg)
    check(torch.equal(perm, perm_plain), f"{what}: K5 perm vs the plain version's")
    check_same_bits(q, q_plain, f"{what}: K5 fields vs the plain version's",
                    FIELDS)
    check(torch.equal(reorder.reorder_by_cell_cuda(p, height, cfg)[1], perm),
          f"{what}: K5 gives two perms on one input")
    del q_plain, perm_plain
    res["reorder"] = dict(
        max_abs_err=0.0,
        slots_moved_share=float((perm != torch.arange(
            n, dtype=torch.int32, device=device)).float().mean()),
        ms=cuda_ms(lambda: reorder.reorder_by_cell_cuda(p, height, cfg), 5),
        plain_ms=cuda_ms(lambda: reorder.reorder_by_cell_plain(p, height, cfg),
                         2))
    del perm

    # K6 at the step's time weights and flux memory, then K7 on the sorted
    # particles with the step's key; the step goes on with K7's particles
    kern = sim.conv_kernel
    fields = tuple(getattr(e, name) for e in (eta0, eta1)
                   for name in ("ps", "tth", "qvh", "tt2", "td2"))
    dt1, dt2 = float(itime - mt0), float(mt1 - itime)
    dtt = 1.0 / (dt1 + dt2)
    tw = (float(np.float32(dt2 * dtt)), float(np.float32(dt1 * dtt)))
    conv, _, k6 = check_convection(kern, fields, cbmf, f"{what}:", tw)
    res["convection"] = dict(
        **k6, ms=cuda_ms(lambda: cv.convection_cuda(kern, fields, *tw, cbmf,
                                                    float(LSYNC)), 10),
        plain_ms=cuda_ms(lambda: cv.convection_plain(kern, fields, *tw,
                                                     cbmf, float(LSYNC)), 2))
    key = rng.Key(sim.seed, istep)
    k0, k1 = key.philox_key(cv.REDIST_TAG)
    own = rng.uniforms_plain(n, k0, k1, device)
    k7 = check_redist(q, key, conv, kern, sim.grid, own,
                      f"{what}: K7 injected", itime)
    args7 = redist_args(conv, kern, sim.grid, itime)
    q_in = q
    q_inj, m_inj = cv.redist_cuda(q_in, key, *args7, rn=own)
    q, m_reg = cv.redist_cuda(q_in, key, *args7)
    check_same_bits(q, q_inj, f"{what}: K7 uniforms in registers vs "
                    "rng.uniforms_plain's", ("z",))
    check(int(m_reg) == int(m_inj), f"{what}: K7 moved counts differ")
    # The step's plume lies outside SyntheticMet's convecting bands, so K7
    # finds no live particle in it: it is held once more on the step's own
    # matrices with the particles put in the convecting columns
    q_live = on_convecting_columns(q_in, conv, sim.grid, itime,
                                   f"{what}: K7")
    k7_live = check_redist(q_live, key, conv, kern, sim.grid, own,
                           f"{what}: K7 on convecting columns", itime)
    check(k7_live["moved"] > 0, f"{what}: K7 moved no particle of the "
          "step's convecting columns")
    # ... and once more on those particles in cell order, as the run
    # would hold them after a sort
    q_live_sorted = reorder.reorder_by_cell_cuda(q_live, height, cfg)[0]
    k7_live_sorted = check_redist(q_live_sorted, key, conv, kern, sim.grid,
                                  None, f"{what}: K7 on convecting columns, "
                                  "cell-ordered", itime)
    res["redist"] = dict(
        **k7, **k7_bound(q_in, conv, kern, sim.grid, itime),
        on_convecting_columns=dict(
            **k7_live, **k7_bound(q_live, conv, kern, sim.grid, itime),
            ms=cuda_ms(lambda: cv.redist_cuda(q_live, key, *args7), 10)),
        on_convecting_columns_cell_ordered=dict(
            **k7_live_sorted,
            **k7_bound(q_live_sorted, conv, kern, sim.grid, itime),
            ms=cuda_ms(lambda: cv.redist_cuda(q_live_sorted, key, *args7),
                       10)),
        ms=cuda_ms(lambda: cv.redist_cuda(q_in, key, *args7), 10),
        plain_ms=cuda_ms(lambda: cv.redist_plain(q_in, key, *args7), 2))
    del q_in, q_inj, q_live, q_live_sorted, conv, fields

    # K3 on the sorted particles, as the step samples them
    res["conccalc"] = sim_conccalc_checks(sim, q, z1, itime, what)

    # K4 on the sorted particles with the step's key
    key = rng.Key(sim.seed, istep)
    a = advance.advance_args(cfg, prm, itime, mt0, mt1)
    draws = {tag: rng.normals(key, (rows, n), tag, device=device)
             for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}

    def kernel(d=draws):
        return advance.advance_all_cuda(q, height, tk, a, key, cfg, d, 0)

    def plain():
        return advance.advance_all_plain(q, height, tp, a, key, cfg, draws, 0)

    (pk, dk), (pp, dp) = kernel(), plain()
    torch.cuda.synchronize()
    k4 = compare_particles(pk, pp, f"{what}: K4", float(cfg.nx - 1))
    for f in ("n_active", "n_exited"):
        check(abs(int(getattr(dk, f)) - int(getattr(dp, f)))
              <= K4_FLAG_SHARE * n, f"{what}: K4 {f} differs")
    check_same_bits(kernel(None)[0], pk,
                    f"{what}: K4 draws in registers vs injected")
    branches = branch_counts(q, pp, height, tp, cfg, itime)
    del pk, pp
    res["advance"] = dict(
        **k4, max_abs_err=max(k4["max_dx"], k4["max_dy"]),
        n_active=int(dk.n_active), n_exited=int(dk.n_exited),
        branches=branches, ms=cuda_ms(lambda: kernel(None), 10),
        plain_ms=cuda_ms(plain, 2))
    del draws
    torch.cuda.empty_cache()
    return res


# the kernels every step of a fixed-step / adaptive sim path launches
PATH_KERNELS = ("quad_tables", "conccalc", "reorder", "convection", "redist",
                "wetdepo", "drydepo", "depo_scatter")
FIXED_PATH_KERNELS = ("advance",) + PATH_KERNELS
ADAPTIVE_PATH_KERNELS = ("advance_adaptive",) + PATH_KERNELS


def kept_steps(sim, nsteps: int, what: str) -> dict:
    """The two steps a sim path keeps for its kernel checks: one in the
    middle of the release (an active plume, a block just woken in the last
    slots, the rest unscheduled) and the last step that advances, long
    after it.  Returns {step: name}."""
    release_steps = sorted(abs(t) // LSYNC for t in sim._release_times)
    keep = {release_steps[len(release_steps) // 2]: "release step",
            nsteps - 1: "steady step"}
    check(len(keep) == 2 and nsteps - 1 > release_steps[-1],
          f"{what}: release steps {release_steps} leave no steady step")
    return keep


def sim_run_checks(sim, what: str, released: float) -> tuple:
    """What every sim path holds after a run: particle steps were made and
    the met reader never failed; all particles active and finite; the
    tracer (species 0) deposits nothing and its mass is recovered from the
    last file within 1e-3; the aerosol's (species 1) budget, airborne +
    wet + dry = ``released``, within 1e-3, its deposits above zero.
    Returns (the numbers, the last file's name, its conc)."""
    import numpy as np
    import torch
    check(sim.timings["particle_steps"] > 0 and sim._prefetch_failures == 0,
          f"{what}: no particle steps, or the met reader failed")
    pa = sim.particles
    check(int(pa.active.sum()) == N_MAIN,
          f"{what}: {int(pa.active.sum())} of {N_MAIN} active")
    for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "up", "vp", "wp"):
        check(bool(torch.isfinite(getattr(pa, f)).all()),
              f"{what}: {f} not finite")
    out = Path(sim.outdir)
    npz = sorted(q.name for q in out.glob("grid_conc_*.npz"))
    check(len(npz) >= 1, f"{what}: npz {npz}")
    conc = np.load(out / npz[-1])["conc"]
    check(bool(np.isfinite(conc).all()), f"{what}: conc not finite")
    mass = float((conc[0, 0, 0] * sim.geo.volume).sum() / 1e12)
    check(abs(mass - 1.0) < 1e-3, f"{what}: tracer mass {mass}")
    grids = (("wet", sim.acc.wetgridunc), ("dry", sim.acc.drygridunc))
    for k, g in grids:
        check(float(g[..., 0].abs().sum()) == 0.0,
              f"{what}: the tracer has a {k} deposit")
    budget = dict(
        released=released,
        airborne=float(pa.mass[pa.active, 1].sum(dtype=torch.float64)),
        **{k: float(g[..., 1].sum(dtype=torch.float64)) for k, g in grids})
    budget["sum"] = budget["airborne"] + budget["wet"] + budget["dry"]
    check(budget["wet"] > 0.0 and budget["dry"] > 0.0,
          f"{what}: the aerosol deposits {budget}")
    check(abs(budget["sum"] - released) <= 1e-3 * released,
          f"{what}: budget {budget}")
    return dict(tracer_mass_fraction=mass, aerosol_budget=budget), npz[-1], \
        conc


def run_twice(setup, kernels, what: str, released: float, path_kernels,
              check_a=None, probe_fn=None, wrap=None,
              run_checks=sim_run_checks):
    """A Simulation path run twice with one seed, the one two-run check of
    every sim path.  Run A (``setup("a")``) carries no probe and is timed
    as a whole, its launch counts set to 0 just before and read just
    after: each kernel of ``path_kernels`` must have been launched, K5 once
    per sort; ``run_checks`` (sim_run_checks unless given: a backward run
    has checks of its own) holds its particles, files and budget, and
    ``check_a(sim)`` (if given) adds the path's own checks and numbers.
    Run B (``setup("b")``) runs under torch.profiler, with
    ``probe_fn(sim)`` as its step probe (a probe may wait for the card)
    and ``wrap(inner)`` around the run's advance_all.  The two runs must
    end in bitwise equal particles, nan counts and sorts, their deposition
    grids within K8's rtol (its float atomics add in another order in
    every run) and their last conc within K3's.  Returns (sim B, its
    profile rows, the numbers of the two runs)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from flexpart_tpu_torch.core.state import FIELDS
    from flexpart_tpu_torch.run import simulation as simmod
    t_setup = time.perf_counter()
    sim = setup("a")
    setup_s = time.perf_counter() - t_setup
    launches, run_s = counted_run(kernels, sim.run)
    for name in path_kernels:
        check(launches[name] > 0, f"{what}: kernel {name} was never launched")
    check(launches["reorder"] == sim.n_sorts,
          f"{what}: sorts and K5 launches differ")
    checks, last, conc_a = run_checks(sim, what, released)
    a = dict(setup_s=setup_s, run_s=run_s, launches=launches,
             particle_steps=sim.timings["particle_steps"],
             particle_steps_per_s_whole_run=sim.timings["particle_steps"]
             / run_s,
             section_seconds_unsynced={k: v for k, v in sim.timings.items()
                                       if k != "particle_steps"},
             nan_count=sim.nan_count, sorts=sim.n_sorts, **checks)
    if check_a is not None:
        a.update(check_a(sim))
    pa = sim.particles
    wet_a = sim.acc.wetgridunc.clone()
    dry_a = sim.acc.drygridunc.clone()
    del sim
    t0 = time.perf_counter()
    sim = setup("b")
    if probe_fn is not None:
        sim._step_probe = probe_fn(sim)
    inner = simmod.advance_all
    if wrap is not None:
        simmod.advance_all = wrap(inner)
    try:
        # the card's kernels only: recording every host op would slow the
        # run's host side, which bounds it
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sim.run()
            torch.cuda.synchronize()
    finally:
        simmod.advance_all = inner
    a["run_b_s"] = time.perf_counter() - t0
    check_same_bits(pa, sim.particles, f"{what}: two runs with one seed",
                    FIELDS)
    check(sim.nan_count == a["nan_count"],
          f"{what}: nan_count {a['nan_count']} then {sim.nan_count}")
    check(sim.n_sorts == a["sorts"], f"{what}: the two runs sorted "
          "differently")
    depo_diff = {}
    for k, ga, gb in (("wet", wet_a, sim.acc.wetgridunc),
                      ("dry", dry_a, sim.acc.drygridunc)):
        d = (ga - gb).abs()
        depo_diff[k] = float(d.max())
        check(bool(torch.all(d <= K8_RTOL * ga.abs())),
              f"{what}: {k} grids of two runs with one seed differ by "
              f"{depo_diff[k]}")
    conc_b = np.load(Path(sim.outdir) / last)["conc"]
    worst = float(np.abs(conc_a - conc_b).max())
    check(bool(np.all(np.abs(conc_a - conc_b) <= K3_RTOL * np.abs(conc_a))),
          f"{what}: conc of two runs with one seed differs by {worst}")
    a.update(two_runs_bitwise_equal=True, conc_two_runs_max_abs_diff=worst,
             depo_grids_two_runs_max_abs_diff=depo_diff)
    rows = device_rows(prof)
    del prof, pa, wet_a, dry_a
    # the device functions of each kernel, as the profiler names them (an
    # instantiation launched through an entry of its own by its template's)
    words = {"reorder": SORT_KERNELS, "depo_scatter": ("depo_grid_kernel",),
             "domainfill": ("boundary_",), "receptors": ("receptor_",),
             **{k.name: (f"{k.kernel.name}_kernel",) for k in kernels
                if hasattr(k, "kernel")}}
    for name in path_kernels:
        check(any(w in r[0] for r in rows
                  for w in words.get(name, (f"{name}_kernel",))),
              f"{what}: the profile of run B holds no {name} kernel")
    return sim, rows, a


def per_launch_of(rows):
    """(device ms of all kernels, per_launch(words, n)): the device time of
    the profile rows whose name holds one of ``words``, per call of ``n``,
    and its share of all."""
    device_ms = sum(r[2] for r in rows)

    def per_launch(words, n):
        hit = [r for r in rows if any(w in r[0] for w in words)]
        ms = sum(r[2] for r in hit)
        return dict(ms_total=ms, kernels=sum(r[1] for r in hit),
                    ms_per_call=ms / max(n, 1), calls=n,
                    device_share=ms / max(device_ms, 1e-9))
    return device_ms, per_launch


def phase_sim(device, kernels, held: dict) -> dict:
    """``Simulation.run`` on the card, twice with one seed (run_twice).  Run
    A carries no probe and never waits for the card inside a step: it is
    timed as a whole, and its launch counts are the path's; its files must
    have the recipe's names and shapes, and per step it counts the columns
    that convect and the particles that convection moved.  Run B runs
    under torch.profiler with the section timers synchronised and a probe
    at the top of every step, after the step's release and before its
    sort if it has one: the probe waits for the card and reads the host
    clock, takes the share of active particles whose cell key is below
    their left neighbour's, and keeps the ensemble, the met fields
    (processed and raw) and the convective flux memory of one release step
    and of one steady step (kept_steps); then every kernel is held against
    its plain version on those two (``sim_kernel_checks``).  Run A's end
    state (particles, deposition grids) goes into ``held`` and its files
    stay in SIM_DIR / "a": the sim_npz phase holds its run to them."""
    import shutil
    import numpy as np
    import torch
    from flexpart_tpu_torch.core import reorder
    try:
        import h5py  # noqa: F401
        netcdf = True
    except ImportError:
        netcdf = False
    shutil.rmtree(SIM_DIR, ignore_errors=True)
    nsteps = SIM_HOURS * 3600 // LSYNC
    keep, stamps, shares, snaps = {}, [], [], {}

    def setup(run):
        sim = sim_setup(SIM_DIR / run, device, netcdf and run == "a",
                        profile=run == "b")
        keep.update(kept_steps(sim, nsteps, "sim"))
        return sim

    def check_a(sim):
        check(sim.step_cfg.polar and sim.conv_kernel is not None
              and sim.cmd.lsubgrid == 1, "sim: not the default Command's path")
        conv_counts = torch.stack(sim.convection_counts).cpu().numpy()
        check(bool((conv_counts[:, 0] > 0).all()), "sim: a step had no "
              "convecting column")
        # the files of the recipe, with its names and shapes
        out = Path(sim.outdir)
        dates = (out / "dates").read_text().split()
        check(dates == ["20200101013000", "20200101023000"],
              f"sim: dates {dates}")
        npz = sorted(q.name for q in out.glob("grid_conc_*.npz"))
        check(npz == [f"grid_conc_{d}.npz" for d in dates], f"sim: npz {npz}")
        check(len(list(out.glob("grid_conc_*.nc"))) == int(netcdf),
              "sim: nc files")
        last = np.load(out / npz[-1])
        # (species, release box, age class, level, y, x)
        check(last["conc"].shape == (2, 2, 1, 3, 360, 720),
              f"sim: conc {last['conc'].shape}")
        check(float(np.abs(last["conc"][0, 1]).max()) == 0.0,
              "sim: the storm box released the first species")
        for k in ("wet", "dry"):
            check(last[k].shape == (2, 2, 1, 360, 720)
                  and bool(np.isfinite(last[k]).all()), f"sim: npz {k}")
        held.update(particles=sim.particles, wet=sim.acc.wetgridunc,
                    dry=sim.acc.drygridunc, outdir=out, sorts=sim.n_sorts,
                    nan_count=sim.nan_count)
        return dict(convecting_columns_per_step=[int(c) for c in
                                                 conv_counts[:, 0]],
                    convection_moved_per_step=[int(m) for m in
                                               conv_counts[:, 1]])

    def probe_fn(sim):
        def probe(istep, itime):
            torch.cuda.synchronize()
            t_in = time.perf_counter()
            p = sim.particles
            z0, z1, mt0, mt1 = sim._fields_for(itime)
            keys = reorder.cell_keys(p, z0.height, sim.step_cfg)
            below = (keys[1:] < keys[:-1]) & p.active[1:]
            shares.append(torch.stack([below.sum(), p.active.sum()]))
            if istep in keep:
                snaps[keep[istep]] = (istep, itime, p, z0, z1, mt0, mt1,
                                      sim._get_eta(mt0), sim._get_eta(mt1),
                                      sim.cbmf)
            torch.cuda.synchronize()
            stamps.append((t_in, time.perf_counter()))
        return probe

    # species 2: one unit from each box (Cs-137 decays by 8e-6 in 3 h)
    sim, rows, a = run_twice(setup, kernels, "sim", 2.0, FIXED_PATH_KERNELS,
                             check_a, probe_fn)
    launches = a["launches"]
    check(launches["advance"] == nsteps and launches["quad_tables"] == nsteps,
          f"sim: {launches} launches in {nsteps} steps")
    # wet deposition on every step but the first, decay and dry deposition
    # after every advance, a deposit scatter after each
    check(launches["wetdepo"] == launches["drydepo"] == nsteps
          and launches["depo_scatter"] == 2 * nsteps,
          f"sim: {launches} deposition launches in {nsteps} steps")
    # convection runs on every step, the last (which does not advance) too
    check(launches["convection"] == launches["redist"] == nsteps + 1,
          f"sim: {launches} convection launches in {nsteps + 1} steps")
    sorts = a["sorts"]
    device_ms, per_launch = per_launch_of(rows)
    counts = torch.stack(shares).cpu().numpy()
    out_of_order = [float(b) / max(int(a_), 1) for b, a_ in counts]
    report = sim.timers.report()
    release_steps = sorted(t // LSYNC for t in sim._release_times)
    # stamps[i]: the host clock as the probe of step i of run B began and
    # ended, the card idle both times; a step lasts from the end of its
    # probe to the beginning of the next
    first_steady = release_steps[-1] + 1
    step_s = np.array([stamps[i + 1][0] - stamps[i][1]
                       for i in range(len(stamps) - 1)])
    steady, release = step_s[first_steady:], step_s[:first_steady]
    check(set(snaps) == set(keep.values()), f"sim: kept steps {list(snaps)}")
    on_sim_inputs = {name.replace(" ", "_"): sim_kernel_checks(
        sim, snap, f"sim {name} {snap[0]}") for name, snap in snaps.items()}
    snaps.clear()
    res = dict(
        n=N_MAIN, steps=nsteps, netcdf=netcdf, release_steps=release_steps,
        # run A: no probe, no wait for the card inside a step
        **a,
        # run B: under the profiler, synchronised at the top of every step
        synced_first_step_s=float(release[0]),
        synced_release_step_s=[float(x) for x in release[1:]],
        synced_steady_step_s=[float(x) for x in steady],
        synced_steady_step_mean_s=float(steady.mean()),
        # all N_MAIN particles are active on every step after the last release
        synced_steady_particle_steps_per_s=float(
            N_MAIN * len(steady) / steady.sum()),
        active_out_of_order_share=out_of_order,
        active_per_step=[int(a_) for _, a_ in counts],
        columns=SIM_GRID["nx"] * SIM_GRID["ny"],
        section_table_synced=report.splitlines(),
        device_per_call={
            "advance": per_launch(("advance_kernel",), nsteps),
            "quad_tables": per_launch(("quad_tables_kernel",), nsteps),
            "conccalc": per_launch(("conccalc_kernel",), launches["conccalc"]),
            "reorder": per_launch(SORT_KERNELS, sorts),
            "convection": per_launch(("convection_kernel",), nsteps + 1),
            "redist": per_launch(("redist_kernel",), nsteps + 1),
            "wetdepo": per_launch(("wetdepo_kernel",), nsteps),
            "drydepo": per_launch(("drydepo_kernel",), nsteps),
            "depo_scatter": per_launch(("depo_grid_kernel",),
                                       2 * nsteps)},
        device_ms_all_kernels=device_ms,
        top=[dict(name=k[:60], calls=c, ms=ms) for k, c, ms in rows[:10]],
        kernels_on_sim_inputs=on_sim_inputs)
    del sim
    shutil.rmtree(SIM_DIR / "b", ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# -------------------------------------------------- the CLI on npz met --

SIM_NPZ_DIR = ROOT / "build" / "sim_npz_smoke"
# the met archives: one per hour of the run and one more, the hour the
# reader reads ahead at the run's end (Simulation._fields_for)
SIM_NPZ_HOURS = SIM_HOURS + 2
# the npz keys that sampling and deposition fill through float atomics
# (K3, K8): two runs with one seed agree within these rtols, not in bits
NPZ_ATOMIC_RTOL = {"conc": K3_RTOL, "wet": K8_RTOL, "dry": K8_RTOL}
# Species fields <- the SPECIES file's keys (config/species.py)
SPECIES_KEYS = {
    "name": "pspecies", "decay_halflife": "pdecay", "weta_gas": "pweta_gas",
    "wetb_gas": "pwetb_gas", "crain_aero": "pcrain_aero",
    "csnow_aero": "pcsnow_aero", "ccn_aero": "pccn_aero",
    "in_aero": "pin_aero", "density": "pdensity", "dquer": "pdquer",
    "dsigma": "pdsigma", "dryvel": "pdryvel", "reldiff": "preldiff",
    "henry": "phenry", "f0": "pf0", "weightmolar": "pweightmolar",
    "ohcconst": "pohcconst", "ohdconst": "pohdconst",
    "ohnconst": "pohnconst"}


def namelist(group: str, values: dict) -> str:
    """One namelist group in the reference's layout; floats as their
    shortest exact decimal (``repr``), so that a parser reads them back
    bit for bit."""
    def fmt(v):
        if isinstance(v, str):
            return f'"{v}"'
        if isinstance(v, (tuple, list)):
            return ",".join(fmt(x) for x in v)
        return repr(float(v)) if isinstance(v, float) else str(int(v))
    body = "".join(f" {k.upper()}={fmt(v)},\n" for k, v in values.items())
    return f"&{group.upper()}\n{body} /\n"


def fields_of(obj) -> dict:
    """Every field of a dataclass instance, by name."""
    import dataclasses
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def changed(obj) -> dict:
    """The fields of a dataclass instance that differ from their defaults
    (what a namelist file must state)."""
    import dataclasses
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.default is dataclasses.MISSING
            or getattr(obj, f.name) != f.default}


def metres_for_microns(um: float) -> float:
    """The float64 that readspecies' metre -> micron conversion (x 1e6,
    config/species.py) turns into ``um`` exactly: PDQUER is given in
    metres, and 0.4e-6 * 1e6 is not 0.4."""
    import numpy as np
    m = um * 1e-6
    for _ in range(64):
        if m * 1e6 == um:
            return m
        m = float(np.nextafter(m, np.inf if m * 1e6 < um else -np.inf))
    raise ValueError(f"no float64 in metres gives {um} um")


def write_sim_npz_job(job: Path, metdir: Path) -> Path:
    """options/COMMAND, RELEASES, SPECIES/SPECIES_00n and OUTGRID stating
    sim_config(), and the pathnames file; returns the pathnames path."""
    cmd, releases, og = sim_config()
    opts = job / "options"
    (opts / "SPECIES").mkdir(parents=True)
    (job / "output").mkdir()
    (opts / "COMMAND").write_text(namelist("command", changed(cmd)))
    text = namelist("releases_ctrl", dict(
        nspec=releases.nspec,
        specnum_rel=tuple(range(1, releases.nspec + 1))))
    for box in releases.boxes:
        text += namelist("release", fields_of(box))
    (opts / "RELEASES").write_text(text)
    for k, sp in enumerate(releases.species, 1):
        vals = {SPECIES_KEYS[f]: v for f, v in changed(sp).items()
                if f != "specnum"}
        vals.setdefault("pspecies", sp.name)
        if "pdquer" in vals:
            vals["pdquer"] = metres_for_microns(sp.dquer)
        (opts / "SPECIES" / f"SPECIES_{k:03d}").write_text(
            namelist("species_params", vals))
    (opts / "OUTGRID").write_text(namelist("outgrid", fields_of(og)))
    (job / "pathnames").write_text(
        f"{opts}/\n{job / 'output'}/\n{metdir}/\n{metdir / 'AVAILABLE'}\n")
    return job / "pathnames"


def write_sim_npz_met(metdir: Path) -> dict:
    """The sim phase's met (SyntheticMet on SIM_GRID) as npz archives of
    the port's save_eta_npz, one per hour, and their AVAILABLE index: each
    archive built and compressed by a thread of its own (numpy and zlib
    release the interpreter).  Returns the seconds, files and bytes."""
    from concurrent.futures import ThreadPoolExecutor
    from flexpart_tpu_torch.met import SyntheticMet, make_grid
    from flexpart_tpu_torch.met.npzmet import save_eta_npz
    grid = make_grid(**SIM_GRID)
    met = SyntheticMet(grid)
    metdir.mkdir(parents=True)
    names = [f"EN20200101{h:02d}.npz" for h in range(SIM_NPZ_HOURS)]

    def one(h):
        save_eta_npz(metdir / names[h], met.fetch(h * 3600.0, "cpu"), grid)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(one, range(len(names))))
    seconds = time.perf_counter() - t0
    (metdir / "AVAILABLE").write_text("\n".join(
        ["DATE     TIME        FILENAME     SPECIFICATIONS",
         "YYYYMMDD HHMISS", "________ ______      __________      ______"]
        + [f"20200101 {h:02d}0000      {n}      ON DISC"
           for h, n in enumerate(names)]) + "\n")
    return dict(write_s=seconds, threads=len(names), files=len(names),
                bytes=sum((metdir / n).stat().st_size for n in names),
                raw_bytes_per_file=4 * (6 * grid.nlev + 13) * grid.ny
                * grid.nx)


BANNER = ("CONGRATULATIONS: YOU HAVE SUCCESSFULLY COMPLETED A FLEXPART "
          "MODEL RUN!")


def cli_run(pathnames: Path, kernels, device, what: str,
            hook=None) -> tuple:
    """``python -m flexpart_tpu_torch pathnames --device <device>``'s main()
    in this process on a job that states sim_config() (checked on the
    Simulation the CLI builds; ``hook(sim)``, if given, sees it before
    its run), its launch counts set to 0 just before and read just after,
    its run timed on the host clock as the sim phase's run A is, its
    standard output echoed: it must print the psteps line and the success
    banner.  Returns (the Simulation, the launches, the CLI's seconds, the
    run's seconds)."""
    import contextlib
    import dataclasses
    import io
    import torch
    from flexpart_tpu_torch import main as cli
    cmd, releases, og = sim_config()
    caught, times = {}, {}
    build = cli.build_simulation

    def build_and_time(*args, **kw):
        sim = build(*args, **kw)
        check(sim.cmd == cmd and sim.outgrid == og and sim.releases
              .boxes == releases.boxes and tuple(
                  dataclasses.replace(sp, specnum=0) for sp in
                  sim.releases.species) == releases.species,
              f"{what}: the job files do not state the sim configuration")
        if hook is not None:
            hook(sim)
        inner = sim.run

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **k)
            torch.cuda.synchronize()
            times["run_s"] = time.perf_counter() - t0
            return out
        sim.run = run
        caught["sim"] = sim
        return sim

    stdout = io.StringIO()
    cli.build_simulation = build_and_time
    try:
        with contextlib.redirect_stdout(stdout):
            launches, cli_s = counted_run(kernels, lambda: caught.update(
                rc=cli.main([str(pathnames), "--device", str(device)])))
    finally:
        cli.build_simulation = build
    said = stdout.getvalue()
    print(said, end="", flush=True)
    check(caught["rc"] == 0 and BANNER in said and "psteps/s" in said,
          f"{what}: no banner")
    return caught["sim"], launches, cli_s, times["run_s"]


def phase_sim_npz(device, kernels, held: dict, simres: dict) -> dict:
    """The sim phase's run through the command line on npz met
    (``python -m flexpart_tpu_torch pathnames``'s main() in this process),
    once, timed as the sim phase's run A.  The job's files must state the
    sim phase's configuration; the run must launch every kernel of the
    sim path as often as run A did, end in run A's particles bit for bit
    and write run A's npz files (the keys filled through float atomics
    within K3's and K8's rtol, all others bitwise), and its header and
    grid_conc_ files must read back to the npz of their step."""
    import shutil
    import numpy as np
    import torch
    from flexpart_tpu_torch.core.state import FIELDS
    from flexpart_tpu_torch.io.fortran_writer import (read_grid_sparse,
                                                      read_header)
    shutil.rmtree(SIM_NPZ_DIR, ignore_errors=True)
    met = write_sim_npz_met(SIM_NPZ_DIR / "metdata")
    pathnames = write_sim_npz_job(SIM_NPZ_DIR / "job", SIM_NPZ_DIR /
                                  "metdata")
    _, releases, og = sim_config()
    sim, launches, cli_s, run_s = cli_run(pathnames, kernels, device,
                                          "sim_npz")
    check(sim.write_fortran and not sim.write_netcdf,
          "sim_npz: the default Command writes the Fortran files")
    for name in FIXED_PATH_KERNELS:
        check(launches[name] > 0, f"sim_npz: kernel {name} never launched")
    check(launches == simres["launches"], f"sim_npz: launches {launches} "
          f"against run A's {simres['launches']}")
    check(sim.n_sorts == held["sorts"] and sim.nan_count == held["nan_count"],
          "sim_npz: sorts or nan counts differ from run A's")
    check_same_bits(held["particles"], sim.particles,
                    "sim_npz against sim's run A", FIELDS)
    depo = {}
    for k in ("wet", "dry"):
        ga, gb = held[k], getattr(sim.acc, f"{k}gridunc")
        depo[k] = dict(bitwise=bool(torch.equal(ga, gb)),
                       max_abs_diff=float((ga - gb).abs().max()))
        check(bool(torch.all((ga - gb).abs() <= K8_RTOL * ga.abs())),
              f"sim_npz: {k} grid against run A's {depo[k]}")
    # the npz files against run A's
    out, out_a = Path(sim.outdir), held["outdir"]
    check((out / "dates").read_text() == (out_a / "dates").read_text(),
          "sim_npz: dates")
    npz = sorted(q.name for q in out.glob("grid_conc_*.npz"))
    check(npz == sorted(q.name for q in out_a.glob("grid_conc_*.npz"))
          and len(npz) == SIM_HOURS - 1, f"sim_npz: npz {npz}")
    npz_keys = {}
    for name in npz:
        with np.load(out / name) as b, np.load(out_a / name) as a:
            check(sorted(a.files) == sorted(b.files), f"sim_npz: {name} keys")
            for k in a.files:
                same = bool(np.array_equal(a[k], b[k]))
                diff = float(np.abs(a[k] - b[k]).max()) if a[k].size else 0.0
                npz_keys.setdefault(k, []).append(dict(bitwise=same,
                                                       max_abs_diff=diff))
                if k in NPZ_ATOMIC_RTOL:
                    check(a[k].dtype == b[k].dtype and bool(np.all(
                        np.abs(a[k] - b[k])
                        <= NPZ_ATOMIC_RTOL[k] * np.abs(a[k]))),
                        f"sim_npz: {name} {k} against run A's ({diff})")
                else:
                    check(same, f"sim_npz: {name} {k} differs from run A's")
    # the reference's files: the header, and per output step and species
    # grid_conc_ (read back equal to the npz of its step) and grid_pptv_
    h = read_header(out / "header")
    check(h["flexversion"] == "flexpart_tpu_torch 1.0"
          and (h["ibdate"], h["ibtime"]) == (20200101, 0)
          and (h["numxgrid"], h["numygrid"]) == (720, 360)
          and h["species"] == [sp.name for sp in releases.species]
          and [r["npart"] for r in h["releases"]]
          == [b.parts for b in releases.boxes], f"sim_npz: header {h}")
    nz = len(og.outheights)
    fortran = sorted(q.name for q in out.glob("grid_*_00?"))
    check(len(fortran) == 2 * len(npz) * releases.nspec,
          f"sim_npz: Fortran files {fortran}")
    grid_bitwise = []
    for name in npz:
        with np.load(out / name) as d:
            conc, wet, dry = d["conc"], d["wet"], d["dry"]
        for ks in range(releases.nspec):
            f = out / f"{name[:-4]}_{ks + 1:03d}"
            itime, c, w, dr = read_grid_sparse(f, 720, 360, nz,
                                               npoint=releases.numpoint)
            check(itime == int(name[-10:-8]) * 3600 + 1800
                  and bool(np.allclose(c, conc[ks], rtol=2e-6, atol=1e-12))
                  and bool(np.allclose(w, wet[ks], rtol=2e-6, atol=1e-12))
                  and bool(np.allclose(dr, dry[ks], rtol=2e-6, atol=1e-12)),
                  f"sim_npz: {f.name} against {name}")
            grid_bitwise.append(bool(np.array_equal(
                c, np.where(conc[ks] > np.finfo(np.float32).tiny,
                            conc[ks], 0).astype(np.float32))))
    sec = {k: v for k, v in sim.timings.items() if k != "particle_steps"}
    a_sec = simres["section_seconds_unsynced"]
    res = dict(
        n=N_MAIN, steps=SIM_HOURS * 3600 // LSYNC, met_archives=met,
        launches=launches, cli_s=cli_s, run_s=run_s,
        particle_steps=sim.timings["particle_steps"],
        particle_steps_per_s_whole_run=sim.timings["particle_steps"]
        / run_s,
        section_seconds_unsynced=sec,
        getfields_s=sec.get("getfields", 0.0),
        getfields_fetch_bg_s=sec.get("getfields_fetch_bg", 0.0),
        getfields_proc_bg_s=sec.get("getfields_proc_bg", 0.0),
        output_s=sec.get("output", 0.0),
        output_fortran_s=sec.get("output_fortran", 0.0),
        files_bytes=dict(
            npz=sum((out / n).stat().st_size for n in npz),
            fortran=sum((out / n).stat().st_size for n in fortran)
            + (out / "header").stat().st_size),
        # the same kernels on the same inputs as the sim phase's run B,
        # whose profile gives their device time
        device_busy_share=simres["device_ms_all_kernels"] / 1e3
        / run_s,
        particles_bitwise_equal_to_sim_a=True,
        depo_grids_against_sim_a=depo,
        npz_against_sim_a=npz_keys,
        grid_conc_files_bitwise_to_npz_float32=grid_bitwise,
        sim_run_a=dict(
            run_s=simres["run_s"],
            particle_steps_per_s_whole_run=simres[
                "particle_steps_per_s_whole_run"],
            getfields_s=a_sec.get("getfields", 0.0),
            getfields_fetch_bg_s=a_sec.get("getfields_fetch_bg", 0.0),
            getfields_proc_bg_s=a_sec.get("getfields_proc_bg", 0.0),
            output_s=a_sec.get("output", 0.0),
            device_busy_share=simres["device_ms_all_kernels"] / 1e3
            / simres["run_s"]))
    del sim
    held.clear()
    shutil.rmtree(SIM_NPZ_DIR, ignore_errors=True)
    shutil.rmtree(SIM_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------ the CLI on GRIB met --

SIM_GRIB_DIR = ROOT / "build" / "sim_grib_smoke"
SIM_GFS_DIR = ROOT / "build" / "sim_gfs_smoke"
# NCEP's 1.0-degree pgrb2 files: 26 isobaric levels [hPa]
GFS_LEVELS_HPA = (1000, 975, 950, 925, 900, 850, 800, 750, 700, 650, 600,
                  550, 500, 450, 400, 350, 300, 250, 200, 150, 100, 70, 50,
                  30, 20, 10)
# sim_gfs: a plateau where ps is cut to 85% (about 850 hPa, so 5-6 of the
# isobaric levels lie below ground), under the east half of the first
# release box and the west half of the storm box; cloud water (CLWMR,
# 1000-700 hPa) and at least 1 mm/h of rain over the storm box
GFS_PLATEAU = dict(lon1=1.0, lon2=29.0, lat1=30.0, lat2=60.0, ps_share=0.85)
GFS_CLOUD = dict(lon1=26.0, lon2=32.0, lat1=48.0, lat2=54.0, clwmr=3.0e-4,
                 top_hpa=700.0, min_mm_h=1.0)


def _grib_s16(v: int) -> bytes:
    import struct
    return struct.pack(">H", abs(int(v)) | (0x8000 if v < 0 else 0))


def _grib_s32(v: int) -> bytes:
    import struct
    return struct.pack(">I", abs(int(v)) | (0x80000000 if v < 0 else 0))


def grib2_message(field, lat1: float, lon1: float, dlat: float,
                  dlon: float, disc: int, cat: int, num: int,
                  level_type: int, level: int, pv=()) -> bytes:
    """One GRIB2 message, south row first, simple packing in 16 bits:
    sections 0, 1, 3 (template 3.0), 4 (template 4.0, with ``pv``), 5
    (template 5.0), 6 (no bitmap), 7; the layout of the repo tests'
    encoder (tests/test_gribdec.py), the values packed with numpy."""
    import math
    import struct
    import numpy as np
    field = np.asarray(field, np.float64)
    ny, nx = field.shape
    npts = nx * ny
    fmin = float(field.min())
    rng = float(field.max()) - fmin
    e_scale = -int(math.floor(math.log2(65535.0 / rng))) if rng > 0 else 0
    ints = np.clip(np.round((field.ravel() - fmin) / 2.0 ** e_scale),
                   0, 65535).astype(">u2")

    def sec(n, payload):
        return struct.pack(">IB", len(payload) + 5, n) + payload

    s1 = sec(1, struct.pack(">HHBBBHBBBBB", 98, 0, 2, 1, 1, 2020, 1, 1,
                            0, 0, 0) + b"\x00\x01\x00")
    g = struct.pack(">BIBBH", 0, npts, 0, 0, 0) + b"\x06" + b"\x00" * 15
    g += struct.pack(">IIII", nx, ny, 0, 0)
    g += _grib_s32(round(lat1 * 1e6)) + _grib_s32(round(lon1 * 1e6)) + b"\x30"
    g += _grib_s32(round((lat1 + (ny - 1) * dlat) * 1e6))
    g += _grib_s32(round((lon1 + (nx - 1) * dlon) * 1e6))
    g += struct.pack(">II", round(dlon * 1e6), round(dlat * 1e6)) + b"\x00"
    p = struct.pack(">HHBBBBBHBB", len(pv), 0, cat, num, 0, 0, 0, 0, 0, 1)
    p += struct.pack(">IBBIBBI", 0, level_type, 0, level, 255, 0, 0)
    p += struct.pack(f">{len(pv)}f", *pv)
    d = struct.pack(">IHf", npts, 0, fmin) + _grib_s16(e_scale) \
        + _grib_s16(0) + struct.pack(">BB", 16, 0)
    body = (s1 + sec(3, g) + sec(4, p) + sec(5, d) + sec(6, b"\xff")
            + sec(7, ints.tobytes()))
    return (b"GRIB\x00\x00" + bytes([disc, 2])
            + struct.pack(">Q", 16 + len(body) + 4) + body + b"7777")


def ecmwf_grib(eta, grid) -> bytes:
    """One wind-field time of SyntheticMet as an ECMWF-style GRIB2 file, in
    the units and accumulations that gribmet.eta_from_grib converts back:
    the model levels 1 (top) to nlev - 1 (T, U, V, Q, etadot, cloud liquid
    water), each with the hybrid coefficients as pv (top-down a, then b);
    the surface pressure, 2 m temperature and dew point, 10 m wind (the
    artificial ground level), the sensible heat flux and solar radiation
    in J/m2 over 3600 s, precipitation in m over the hour, cloud cover,
    snow depth (read times 0.1), geopotential, subgrid orography, land
    mask and the stress as EWSS in N m-2 s (NSSS 0).  The grid's first
    nx - 1 columns from lon1 = xlon0, its cyclic column left out."""
    import numpy as np
    nxf = grid.nx - 1

    def f(t):
        return np.asarray(t.cpu().numpy(), np.float64)[..., :nxf]

    def add(field, disc, cat, num, level_type, level, pv=()):
        out.append(grib2_message(field, grid.ylat0, grid.xlon0, grid.dy,
                                 grid.dx, disc, cat, num, level_type, level,
                                 pv))

    pv = [float(v) for v in grid.akm[::-1]] + [float(v)
                                               for v in grid.bkm[::-1]]
    out = []
    nlev_ec = grid.nlev - 1
    ml = {(0, 0): eta.tth, (2, 2): eta.uuh, (2, 3): eta.vvh, (1, 0): eta.qvh,
          (2, 32): eta.wwh, (1, 83): eta.clwch}
    for kz in range(1, nlev_ec + 1):
        for (cat, num), t in ml.items():
            add(f(t[kz]), 0, cat, num, 105, nlev_ec - kz + 1, pv)
    sfc = [(eta.ps, 0, 3, 0, 1), (eta.tt2, 0, 0, 0, 103),
           (eta.td2, 0, 0, 6, 103), (eta.uuh[0], 0, 2, 2, 103),
           (eta.vvh[0], 0, 2, 3, 103), (eta.sshf * 3600.0, 0, 0, 11, 1),
           (eta.ssr * 3600.0, 0, 4, 9, 1), (eta.lsprec / 1000.0, 0, 1, 9, 1),
           (eta.convprec / 1000.0, 0, 1, 10, 1), (eta.tcc, 0, 6, 1, 1),
           (eta.sd * 10.0, 0, 1, 11, 1), (eta.oro * 9.80665, 0, 3, 4, 1),
           (eta.excessoro, 0, 3, 7, 1), (eta.lsm, 2, 0, 0, 1),
           (eta.surfstr * 3600.0, 0, 2, 38, 1),
           (eta.surfstr * 0.0, 0, 2, 37, 1)]
    for t, disc, cat, num, level_type in sfc:
        add(f(t), disc, cat, num, level_type, 0)
    return b"".join(out)


def write_grib_files(metdir: Path, prefix: str, make) -> dict:
    """One GRIB file per hour of the run and the reader's look-ahead,
    ``make(h)`` its bytes, each built and written by a thread of its own
    (numpy releases the interpreter), and their AVAILABLE index.  Returns
    the seconds, files and bytes."""
    from concurrent.futures import ThreadPoolExecutor
    metdir.mkdir(parents=True)
    names = [f"{prefix}20200101{h:02d}" for h in range(SIM_NPZ_HOURS)]

    def one(h):
        (metdir / names[h]).write_bytes(make(h))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(one, range(len(names))))
    seconds = time.perf_counter() - t0
    (metdir / "AVAILABLE").write_text("\n".join(
        ["DATE     TIME        FILENAME     SPECIFICATIONS",
         "YYYYMMDD HHMISS", "________ ______      __________      ______"]
        + [f"20200101 {h:02d}0000      {n}      ON DISC"
           for h, n in enumerate(names)]) + "\n")
    return dict(write_s=seconds, threads=len(names), files=len(names),
                bytes=sum((metdir / n).stat().st_size for n in names))


def box_mask(grid_lons, grid_lats, box) -> "np.ndarray":
    """(ny, nx) mask of the cells inside a lon/lat box."""
    import numpy as np
    lon = np.asarray(grid_lons)[None, :]
    lat = np.asarray(grid_lats)[:, None]
    return ((lon >= box["lon1"]) & (lon <= box["lon2"])
            & (lat >= box["lat1"]) & (lat <= box["lat2"]))


def gfs_grib(eta, grid) -> bytes:
    """One wind-field time of SyntheticMet on SIM_GRID as an NCEP
    GFS-style GRIB2 file on the 1.0-degree grid (360 x 181, 0..359 E,
    south row first): T, U, V, omega (SyntheticMet's etadot), RH and CLWMR
    on the 26 isobaric levels of GFS_LEVELS_HPA, interpolated in ln p from
    the eta levels (held below the lowest and above the top); the surface
    pressure (cut to GFS_PLATEAU's share on its plateau, so that the
    levels below it collapse), 2 m temperature and RH, 10 m wind, the
    lowest sigma level's T, U, V (SyntheticMet's level 1), terrain height,
    land mask, total and convective precipitation rates in mm/s (at least
    GFS_CLOUD's rate over the storm box), cloud cover in percent and snow;
    CLWMR over the storm box raised to GFS_CLOUD's below its top."""
    import numpy as np
    from flexpart_tpu_torch.met.pblprofile import _ew
    nxf = grid.nx - 1

    def f(t):
        # SIM_GRID's columns run from 180 W; NCEP's from 0 E
        a = np.asarray(t.cpu().numpy(), np.float64)[..., :nxf]
        return np.roll(a, -int(round(180.0 / grid.dx)), axis=-1)

    lons = np.arange(nxf) * grid.dx
    lons = np.where(lons >= 180.0, lons - 360.0, lons)
    lats = grid.ylat0 + np.arange(grid.ny) * grid.dy
    ps0 = f(eta.ps)
    p_eta = (grid.akz[:, None, None] + grid.bkz[:, None, None] * ps0[None])
    lnp = np.log(p_eta)
    tth, qvh = f(eta.tth), f(eta.qvh)
    e = qvh * p_eta / (0.622 + 0.378 * qvh)
    rh = np.clip(100.0 * e / _ew(tth), 0.0, 100.0)
    cloud = box_mask(lons, lats, GFS_CLOUD)
    prof = {"T": tth, "U": f(eta.uuh), "V": f(eta.vvh), "W": f(eta.wwh),
            "RH": rh, "CLWMR": f(eta.clwch)}
    roles = {"T": (0, 0, 0), "U": (0, 2, 2), "V": (0, 2, 3), "W": (0, 2, 8),
             "RH": (0, 1, 1), "CLWMR": (0, 1, 22)}
    out = []

    def add(field, disc, cat, num, level_type, level):
        out.append(grib2_message(field, grid.ylat0, 0.0, grid.dy, grid.dx,
                                 disc, cat, num, level_type, level))

    nlev = grid.nlev
    for hpa in GFS_LEVELS_HPA:
        lp = np.log(100.0 * hpa)
        k = np.clip((p_eta >= 100.0 * hpa).sum(axis=0), 1, nlev - 1)[None]
        lo = np.take_along_axis(lnp, k - 1, axis=0)[0]
        hi = np.take_along_axis(lnp, k, axis=0)[0]
        w = np.clip((lo - lp) / (lo - hi), 0.0, 1.0)
        for name, a in prof.items():
            v = (np.take_along_axis(a, k - 1, axis=0)[0] * (1.0 - w)
                 + np.take_along_axis(a, k, axis=0)[0] * w)
            if name == "CLWMR":
                v = np.where(cloud & (hpa >= GFS_CLOUD["top_hpa"]),
                             np.maximum(v, GFS_CLOUD["clwmr"]), v)
            add(v, *roles[name], 100, 100 * hpa)
    plateau = box_mask(lons, lats, GFS_PLATEAU)
    ps = np.where(plateau, GFS_PLATEAU["ps_share"] * ps0, ps0)
    tt2, td2 = f(eta.tt2), f(eta.td2)
    rain = (f(eta.lsprec) + f(eta.convprec)) / 3600.0
    rain = np.where(cloud, np.maximum(rain, GFS_CLOUD["min_mm_h"] / 3600.0),
                    rain)
    topo = f(eta.oro) + np.where(plateau, 8000.0 * np.log(ps0 / ps), 0.0)
    sfc = [(ps, 0, 3, 0, 1, 0), (tt2, 0, 0, 0, 103, 2),
           (100.0 * _ew(td2) / _ew(tt2), 0, 1, 1, 103, 2),
           (f(eta.uuh[0]), 0, 2, 2, 103, 10), (f(eta.vvh[0]), 0, 2, 3, 103, 10),
           (tth[1], 0, 0, 0, 104, 0), (f(eta.uuh[1]), 0, 2, 2, 104, 0),
           (f(eta.vvh[1]), 0, 2, 3, 104, 0), (topo, 0, 3, 5, 1, 0),
           (f(eta.lsm), 2, 0, 0, 1, 0), (rain, 0, 1, 7, 1, 0),
           (f(eta.convprec) / 3600.0, 0, 1, 196, 1, 0),
           (100.0 * f(eta.tcc), 0, 6, 1, 1, 0), (f(eta.sd), 0, 1, 13, 1, 0)]
    for field, disc, cat, num, level_type, level in sfc:
        add(field, disc, cat, num, level_type, level)
    return b"".join(out)


def read_split(backend, sim) -> dict:
    """The met read of a GRIB run: getfields (blocked on the step loop's
    thread), the reader thread's read and processing, and the decoder's
    parts over every file read (scan, decode inside gribdec_decode,
    numpy assembly, the copy to the card; ``gribmet.ReadTimes``)."""
    sec = sim.timings
    return dict(getfields_s=sec.get("getfields", 0.0),
                getfields_fetch_bg_s=sec.get("getfields_fetch_bg", 0.0),
                getfields_proc_bg_s=sec.get("getfields_proc_bg", 0.0),
                files_read=backend.read_times.files,
                read_parts_s=dict(backend.read_times.seconds))


def phase_sim_grib(device, kernels, simres: dict, npzres: dict) -> dict:
    """The sim phase's run through the command line on ECMWF-style GRIB2
    met: SyntheticMet on SIM_GRID (361 x 181 x 30) written as one GRIB2
    file per hour of the run and the reader's look-ahead (ecmwf_grib:
    about 190 messages of 65,160 values each), from threads and timed
    apart; sim_npz's job with its AVAILABLE naming the GRIB files, run once
    through main(), timed as the sim phase's run A.  It must print the
    banner, launch every kernel of the sim path as often as run A did, and
    keep every particle active and finite, the tracer's mass and the
    aerosol's budget (sim_run_checks).  The fields GribMet.fetch returned
    in the run (kept on the card) are then written with save_eta_npz and
    the same job on those archives must end in the same particles, bit for
    bit: the decode is the only difference between the two runs, and it is
    taken out."""
    import shutil
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from flexpart_tpu_torch.core.state import FIELDS
    from flexpart_tpu_torch.met import SyntheticMet, make_grid
    from flexpart_tpu_torch.met.gribmet import GribMet
    from flexpart_tpu_torch.met.npzmet import save_eta_npz
    shutil.rmtree(SIM_GRIB_DIR, ignore_errors=True)
    grid = make_grid(**SIM_GRID)
    met = SyntheticMet(grid)
    gribdir = SIM_GRIB_DIR / "grib"
    files = write_grib_files(gribdir, "EN", lambda h: ecmwf_grib(
        met.fetch(h * 3600.0, "cpu"), grid))
    pathnames = write_sim_npz_job(SIM_GRIB_DIR / "job", gribdir)
    fetched = {}

    def keep_fetched(sim):
        inner = sim.met_backend.fetch

        def fetch(tsec, device):
            fetched[int(tsec)] = eta = inner(tsec, device)
            return eta
        sim.met_backend.fetch = fetch

    sim, launches, cli_s, run_s = cli_run(pathnames, kernels, device,
                                          "sim_grib", keep_fetched)
    check(type(sim.met_backend) is GribMet and not sim.use_clwc
          and (sim.grid.nx, sim.grid.ny, sim.grid.nlev, sim.grid.xlon0)
          == (361, 181, 30, -180.0), "sim_grib: not the ECMWF GRIB path")
    check(launches == simres["launches"], f"sim_grib: launches {launches} "
          f"against the sim phase's run A's {simres['launches']}")
    checks, _, _ = sim_run_checks(sim, "sim_grib", 2.0)
    read = read_split(sim.met_backend, sim)
    particles, grib_grid = sim.particles, sim.grid
    sec = {k: v for k, v in sim.timings.items() if k != "particle_steps"}
    psteps = sim.timings["particle_steps"]
    del sim
    torch.cuda.empty_cache()

    # the same job on npz archives of what GribMet.fetch returned
    npzdir = SIM_GRIB_DIR / "npz"
    npzdir.mkdir()
    names = {t: f"EN20200101{t // 3600:02d}.npz" for t in sorted(fetched)}
    check(len(names) == SIM_NPZ_HOURS, f"sim_grib: read {sorted(names)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(lambda t: save_eta_npz(npzdir / names[t], fetched[t],
                                           grib_grid), names))
    decoded_s = time.perf_counter() - t0
    fetched.clear()
    lines = (gribdir / "AVAILABLE").read_text().splitlines()[:3]
    (npzdir / "AVAILABLE").write_text("\n".join(lines + [
        f"20200101 {t // 3600:02d}0000      {n}      ON DISC"
        for t, n in names.items()]) + "\n")
    again, launches_npz, _, run_npz_s = cli_run(
        write_sim_npz_job(SIM_GRIB_DIR / "job_npz", npzdir), kernels,
        device, "sim_grib on its decoded fields")
    check(launches_npz == launches, "sim_grib: the npz run of the decoded "
          "fields launched otherwise")
    check_same_bits(particles, again.particles,
                    "sim_grib against the npz run of its decoded fields",
                    FIELDS)
    del again, particles
    res = dict(
        n=N_MAIN, steps=SIM_HOURS * 3600 // LSYNC, grib_files=files,
        messages_per_file=6 * (grid.nlev - 1) + 16,
        launches=launches, cli_s=cli_s, run_s=run_s,
        particle_steps=psteps,
        particle_steps_per_s_whole_run=psteps / run_s,
        section_seconds_unsynced=sec, read=read,
        output_s=sec.get("output", 0.0),
        # the same kernels on the same inputs as the sim phase's run B,
        # whose profile gives their device time
        device_busy_share=simres["device_ms_all_kernels"] / 1e3 / run_s,
        decoded_npz_write_s=decoded_s,
        run_on_decoded_npz_s=run_npz_s,
        particles_bitwise_equal_to_npz_run_of_decoded_fields=True,
        sim_run_a=dict(run_s=simres["run_s"],
                       particle_steps_per_s_whole_run=simres[
                           "particle_steps_per_s_whole_run"]),
        sim_npz=dict(run_s=npzres["run_s"],
                     particle_steps_per_s_whole_run=npzres[
                         "particle_steps_per_s_whole_run"],
                     getfields_s=npzres["getfields_s"],
                     getfields_fetch_bg_s=npzres["getfields_fetch_bg_s"]),
        **checks)
    shutil.rmtree(SIM_GRIB_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# the kernels every step of sim_gfs launches: K9 CLWC, not the stock K9
GFS_PATH_KERNELS = tuple("wetdepo.clwc" if k == "wetdepo" else k
                         for k in FIXED_PATH_KERNELS)
# the rules of a scavenged (particle, species) pair (k9_path_calls)
K9_RULES = ("lam_below_gas", "lam_below_aerosol", "lam_in_cloud_aerosol",
            "lam_in_cloud_gas")


def phase_sim_gfs(device, kernels) -> dict:
    """The sim phase's configuration through the command line's
    build_simulation on GFS-style GRIB2 met (gfs_grib: NCEP's 1.0-degree
    grid, 26 isobaric levels, a plateau whose below-ground levels
    collapse, cloud water and rain over the storm box), twice with one
    seed (run_twice): GfsMet's sumclouds turns on use_clwc, so K9 CLWC
    runs at every step and the stock K9 never.  Per kept step K9 CLWC is
    held against its plain version on the step's particles and field, and
    the scavenged (particle, species) pairs are counted per rule; the
    in-cloud rule must scavenge on one of them at least.  The aerosol's
    budget within 1e-3 (sim_run_checks)."""
    import shutil
    import torch
    from flexpart_tpu_torch import main as cli
    from flexpart_tpu_torch.met import SyntheticMet, make_grid
    from flexpart_tpu_torch.met.gfsmet import GfsMet
    from flexpart_tpu_torch.physics import massupdate as mu
    from flexpart_tpu_torch.physics import wetdepo as wd
    shutil.rmtree(SIM_GFS_DIR, ignore_errors=True)
    grid = make_grid(**SIM_GRID)
    met = SyntheticMet(grid)
    gribdir = SIM_GFS_DIR / "grib"
    files = write_grib_files(gribdir, "GF", lambda h: gfs_grib(
        met.fetch(h * 3600.0, "cpu"), grid))
    nsteps = SIM_HOURS * 3600 // LSYNC
    keep, snaps, facts = {}, {}, {}

    def setup(run):
        sim = cli.build_simulation(
            str(write_sim_npz_job(SIM_GFS_DIR / f"job_{run}", gribdir)),
            device=str(device), profile=run == "b")
        keep.update(kept_steps(sim, nsteps, "sim_gfs"))
        return sim

    def check_a(sim):
        g = sim.grid
        check(type(sim.met_backend) is GfsMet and sim.use_clwc
              and g.pressure_levels and (g.nx, g.ny, g.nlev, g.xlon0)
              == (361, 181, len(GFS_LEVELS_HPA), -179.0),
              "sim_gfs: not the GFS path with use_clwc")
        facts["read"] = read_split(sim.met_backend, sim)
        # the (level, column) cells below ground in the first file
        eta = sim.met_backend.fetch(0.0, "cpu")
        below = torch.as_tensor(g.akm, dtype=torch.float32)[:, None, None] \
            >= eta.ps[None]
        facts.update(below_ground_cells=int(below.sum()),
                     below_ground_columns=int(below.any(0).sum()))
        check(facts["below_ground_cells"] > 0, "sim_gfs: no level below "
              "ground")
        return {}

    def probe_fn(sim):
        def probe(istep, itime):
            if istep in keep:
                z0, z1, mt0, mt1 = sim._fields_for(itime)
                snaps[keep[istep]] = (istep, itime, sim.particles, z0, z1,
                                      mt0, mt1)
        return probe

    # species 2: one unit from each box (Cs-137 decays by 8e-6 in 3 h)
    sim, rows, a = run_twice(setup, kernels, "sim_gfs", 2.0,
                             GFS_PATH_KERNELS, check_a, probe_fn)
    launches = a["launches"]
    check(launches["wetdepo.clwc"] == nsteps and launches["wetdepo"] == 0,
          f"sim_gfs: K9 CLWC {launches['wetdepo.clwc']} and K9 "
          f"{launches['wetdepo']} launches in {nsteps} steps")
    device_ms, per_launch = per_launch_of(rows)
    ins = k9_instructions(clwc=True)
    wet, msp = sim.wet_species, sim.mass_species
    on_inputs, rule_share = {}, {}
    for name, (istep, itime, p, z0, z1, mt0, mt1) in snaps.items():
        t = itime
        loutnext = 3600 * max(1, -(-t // 3600))
        ldeltat = t - (loutnext - 3600)
        interp_t = itime - LSYNC // 2
        zw = z0 if abs(mt0 - interp_t) < abs(mt1 - interp_t) else z1
        what = f"sim_gfs {name} {istep}: K9 CLWC"
        r = check_wetdepo(p, zw, wet, msp, ldeltat, what, clwc=True)
        r.pop("deposit")
        check(r["bitwise"], f"{what}: not bitwise")
        r.update(k9_bound(p, zw, wet, msp, ins, clwc=True))
        r["ms"] = cuda_ms(lambda: wd.wetdepo_cuda(p, zw, LSYNC, ldeltat,
                                                  wet, msp, True), 10)
        r["plain_ms"] = cuda_ms(lambda: mu.apply_wetdepo_plain(
            p, *wd.wetscav_all_plain(p, zw, wet, True), LSYNC, ldeltat,
            msp), 3)
        pairs = max(int(p.active.sum()) * p.nspec, 1)
        rule_share[name.replace(" ", "_")] = {
            k: r["path_calls"][k] / pairs for k in K9_RULES}
        on_inputs[name.replace(" ", "_")] = r
    check(any(s["lam_in_cloud_aerosol"] + s["lam_in_cloud_gas"] > 0
              for s in rule_share.values()),
          f"sim_gfs: the in-cloud rule scavenged nothing: {rule_share}")
    snaps.clear()
    res = dict(
        n=N_MAIN, steps=nsteps, grib_files=files,
        levels_hpa=list(GFS_LEVELS_HPA), **facts, **a,
        scavenged_pair_share_by_rule=rule_share,
        device_per_call={
            "wetdepo_clwc": per_launch(("wetdepo_kernel",), nsteps),
            "advance": per_launch(("advance_kernel",), nsteps)},
        device_ms_all_kernels=device_ms,
        device_busy_share=device_ms / 1e3 / a["run_s"],
        kernels_on_sim_gfs_inputs=on_inputs)
    del sim
    shutil.rmtree(SIM_GFS_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------- the adaptive Simulation --

SIM_ADAPTIVE_HOURS = 3
SIM_ADAPTIVE_DIR = ROOT / "build" / "sim_adaptive_smoke"


def sim_adaptive_setup(outdir, device, write_netcdf: bool, n: int = N_MAIN,
                       n_storm: int = N_STORM, cmd_kw=None, **kw):
    """The port's Simulation at full width with ``Command(ctl=5.0)`` (the
    adaptive step: turbswitch on, ifine 4, mintime 1 s; convection and
    subgrid orography on, as in the sim phase), ``n`` = 10 x 2**20
    particles from two boxes of one species each, so that the reference's
    rule turns settling on: the tracer from 40-42 N, 0-2 E (n - n_storm
    particles) and the settling aerosol of aerosol_species from STORM_BOX
    (n_storm particles), both over the first hour at 50-500 m; the sim
    phase's grid, hours and output.  ``cmd_kw`` adds to the Command
    (sim_cbl: cblflag=1)."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox,
                                           Releases)
    grid = make_grid(**SIM_GRID)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=SIM_ADAPTIVE_HOURS * 10000, lsynctime=LSYNC,
                  loutstep=3600, loutaver=3600, loutsample=900, ctl=5.0,
                  **(cmd_kw or {}))
    when = dict(idate1=20200101, itime1=0, idate2=20200101, itime2=10000,
                z1=50.0, z2=500.0)
    boxes = (ReleaseBox(lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0,
                        mass=(1.0, 0.0), parts=n - n_storm, **when),
             ReleaseBox(**STORM_BOX, mass=(0.0, 1.0), parts=n_storm, **when))
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720, numygrid=360,
                 dxout=0.5, dyout=0.5, outheights=(100.0, 1000.0, 50000.0))
    return Simulation(cmd=cmd, releases=Releases(species=aerosol_species(),
                                                 boxes=boxes),
                      grid=grid, met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), device=device,
                      write_netcdf=write_netcdf, **kw)


def sim_adaptive_checks(sim, snap, what: str) -> dict:
    """K11, K4 SETTLING and K10 T_BELOW against their plain versions on one
    kept step of the adaptive ``Simulation.run``: the step's particles
    (after its release, before its sort) put in cell order as the run puts
    them, its tables, its key.  K11 (check_adaptive), and once more without
    settling on the same particles and key: the aerosol ends lower by
    settling alone and the tracer's particles are the same, bitwise; K4's
    SETTLING instantiation, the fixed step of the same species, on the
    same particles; K10's T_BELOW instantiation with K11's t_below and the
    step's deposition velocities.  Each timed beside its plain version."""
    import copy
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    from flexpart_tpu_torch.physics import massupdate as mu
    istep, itime, p, z0, z1, mt0, mt1 = snap[:7]
    cfg, prm = sim.step_cfg, sim.step_prm
    height = z0.height
    check(cfg.method == 1 and cfg.settling and cfg.polar,
          f"{what}: not the adaptive, settling, polar step")
    q = reorder.reorder_by_cell_cuda(p, height, cfg)[0]
    tw = advance._time_weights(itime, mt0, mt1, prm, cfg)[:4]
    tables = interp.build_step_tables_quad(z0, z1, *tw,
                                           dtype=cfg.table_dtype)
    a = advance.advance_args(cfg, prm, itime, mt0, mt1)
    key = rng.Key(sim.seed, istep)
    settle = advance.settle_met(z0, cfg)
    res = dict(istep=istep, itime=itime, scheduled=int(q.active.sum()))
    r, pk, dk = check_adaptive(q, height, tables, a, key, cfg, settle,
                               f"{what}: K11")
    ins = k11_instructions(_build.ADVANCE_ADAPTIVE, k11_entry(cfg), cfg.ifine)
    r.update(k11_bound(q, pk, dk.passes, height, cfg, a, ins))
    del pk
    r["ms"] = cuda_ms(lambda: advance.advance_adaptive_cuda(
        q, height, tables, copy.copy(a), key, cfg, None, 0, settle), 10)
    r["plain_ms"] = cuda_ms(lambda: advance.advance_all_plain(
        q, height, tables, copy.copy(a), key, cfg, None, 0, settle), 1)
    # settling alone: the same step without it
    flat_cfg = type(cfg)(**{**cfg.__dict__, "settling": False})
    flat = advance.advance_adaptive_cuda(
        q, height, tables, advance.advance_args(flat_cfg, prm, itime, mt0,
                                                mt1),
        key, flat_cfg, None, 0, None)[0]
    on = advance.advance_adaptive_cuda(q, height, tables, copy.copy(a), key,
                                       cfg, None, 0, settle)[0]
    aero = q.active & (advance.settling_species(q.mass0) == 1)
    tracer = q.active & ~aero
    check(torch.equal(on.z[tracer], flat.z[tracer]),
          f"{what}: the tracer's particles change with settling")
    r["aerosol_drop_by_settling_m"] = float((flat.z - on.z)[aero].mean())
    check(r["aerosol_drop_by_settling_m"] > 0.0,
          f"{what}: the aerosol does not sink: {r['aerosol_drop_by_settling_m']}")
    del flat, on
    res["advance_adaptive"] = r

    # K4 SETTLING: the fixed step of the same run's species
    fcfg = type(cfg)(**{**cfg.__dict__, "method": 0, "turbswitch": False,
                        "ifine": 1})
    fprm = type(prm)(**{**prm.__dict__, "ctl": -5.0, "fine": 1.0})
    fa = advance.advance_args(fcfg, fprm, itime, mt0, mt1)
    (pk, _), (pp, _) = (
        advance.advance_all_cuda(q, height, tables, copy.copy(fa), key, fcfg,
                                 None, 0, settle),
        advance.advance_all_plain(q, height, tables, copy.copy(fa), key, fcfg,
                                  None, 0, settle))
    torch.cuda.synchronize()
    k4 = compare_particles(pk, pp, f"{what}: K4 SETTLING", float(cfg.nx - 1))
    k4["differing_particles"] = differing_particles(pk, pp,
                                                    advance.OUT_FIELDS)
    check(k4["differing_particles"] == 0, f"{what}: K4 SETTLING differs from "
          f"its plain version in {k4['differing_particles']} particles")
    k4["max_abs_err"] = max(k4["max_dx"], k4["max_dy"])
    k4["ms"] = cuda_ms(lambda: advance.advance_all_cuda(
        q, height, tables, copy.copy(fa), key, fcfg, None, 0, settle), 10)
    k4["plain_ms"] = cuda_ms(lambda: advance.advance_all_plain(
        q, height, tables, copy.copy(fa), key, fcfg, None, 0, settle), 2)
    del pk, pp
    res["advance_settling"] = k4

    # K10 T_BELOW with the step's window
    loutnext = 3600 * max(1, -(-itime // 3600))
    ldeltat = itime - (loutnext - 3600)
    msp = sim.mass_species
    r10 = check_drydepo(q, z1.vdep, msp, ldeltat, f"{what}: K10 T_BELOW",
                        dk.t_below)
    r10.pop("deposit")
    r10["ms"] = cuda_ms(lambda: mu.decay_drydep_cuda(
        q, z1.vdep, LSYNC, ldeltat, msp, True, dk.t_below), 10)
    r10["plain_ms"] = cuda_ms(lambda: mu.apply_decay_drydep_plain(
        q, z1.vdep, LSYNC, ldeltat, msp, True, dk.t_below), 3)
    r10["below_2href_share"] = float((dk.t_below > 0).float().mean())
    res["drydepo_t_below"] = r10
    del dk
    torch.cuda.empty_cache()
    return res


def phase_sim_adaptive(device, kernels) -> dict:
    """``Simulation.run`` with the adaptive step and a settling aerosol on
    the card, twice with one seed (run_twice, as the sim phase): run A's
    launch counts are the path's (K11 every step, K4 never), with the
    mean descent of each species; run B keeps one release step and one
    steady step (kept_steps; sim_adaptive_checks) and each step's pass
    counts (the advance's StepDiag.passes, in the run's slot order: the
    warp efficiency) and K11's work counters (the lane efficiency)."""
    import shutil
    import numpy as np
    import torch
    from flexpart_tpu_torch.core import advance
    shutil.rmtree(SIM_ADAPTIVE_DIR, ignore_errors=True)
    nsteps = SIM_ADAPTIVE_HOURS * 3600 // LSYNC
    keep, snaps, passes, lane_work = {}, {}, [], []

    def setup(run):
        sim = sim_adaptive_setup(SIM_ADAPTIVE_DIR / run, device, False,
                                 profile=run == "b")
        c = sim.step_cfg
        check(c.method == 1 and c.settling and c.turbswitch and c.ifine == 4,
              f"sim_adaptive: {c}")
        keep.update(kept_steps(sim, nsteps, "sim_adaptive"))
        return sim

    def check_a(sim):
        pa = sim.particles
        sp = advance.settling_species(pa.mass0)
        descent = {}
        for name, s in (("tracer", 0), ("aerosol", 1)):
            m = pa.active & (sp == s)
            descent[name] = dict(
                mean_z_m=float(pa.z[m].mean()),
                mean_descent_from_release_m=275.0 - float(pa.z[m].mean()),
                mean_idt_s=float(pa.idt[m].float().mean()))
        npz = list(Path(sim.outdir).glob("grid_conc_*.npz"))
        check(len(npz) == SIM_ADAPTIVE_HOURS - 1, f"sim_adaptive: npz {npz}")
        return dict(descent=descent)

    def probe_fn(sim):
        def probe(istep, itime):
            if istep in keep:
                z0, z1, mt0, mt1 = sim._fields_for(itime)
                snaps[keep[istep]] = (istep, itime, sim.particles, z0, z1,
                                      mt0, mt1)
        return probe

    def wrap(inner):
        def counted(*args, **kw):
            p, diag = inner(*args, **kw)
            passes.append(diag.passes.clone())
            lane_work.append(diag.lane_work.clone())
            return p, diag
        return counted

    # the aerosol: one unit from the storm box
    sim, rows, a = run_twice(setup, kernels, "sim_adaptive", 1.0,
                             ADAPTIVE_PATH_KERNELS, check_a, probe_fn, wrap)
    launches = a["launches"]
    check(launches["advance_adaptive"] == nsteps and launches["advance"] == 0
          and launches["drydepo"] == nsteps
          and launches["depo_scatter"] == 2 * nsteps,
          f"sim_adaptive: {launches} launches in {nsteps} steps")
    device_ms, per_launch = per_launch_of(rows)
    per_step = [warp_efficiency(q) for q in passes]
    allp = torch.cat([q[q > 0] for q in passes])
    steps_pass = dict(
        passes_per_pbl_particle_mean=float(allp.float().mean()),
        passes_per_pbl_particle_p99=float(torch.quantile(
            allp[torch.randperm(allp.numel(), device=allp.device)[:2 ** 24]]
            .float(), 0.99)),
        passes_per_pbl_particle_max=int(allp.max()),
        warp_efficiency_per_step=[s["warp_efficiency"] for s in per_step],
        warp_efficiency_mean=float(np.mean([s["warp_efficiency"]
                                            for s in per_step])),
        warp_efficiency_pooled_per_step=[s["warp_efficiency_pooled"]
                                         for s in per_step],
        warp_efficiency_pooled_run=sum(s["passes_total"] for s in per_step)
        / sum(s["warp_lane_iterations"] for s in per_step),
        lane_efficiency_per_step=[lane_efficiency(w)["lane_efficiency"]
                                  for w in lane_work],
        lane_efficiency_run=lane_efficiency(
            torch.stack(lane_work).sum(dim=0))["lane_efficiency"])
    del passes, allp, lane_work
    check(set(snaps) == set(keep.values()),
          f"sim_adaptive: kept steps {list(snaps)}")
    on_inputs = {name.replace(" ", "_"): sim_adaptive_checks(
        sim, snap, f"sim_adaptive {name} {snap[0]}")
        for name, snap in snaps.items()}
    snaps.clear()
    sorts = a["sorts"]
    res = dict(
        n=N_MAIN, steps=nsteps, hours=SIM_ADAPTIVE_HOURS,
        release_steps=sorted(t // LSYNC for t in sim._release_times), **a,
        **steps_pass,
        device_ms_all_kernels=device_ms,
        device_per_call={
            "advance_adaptive": per_launch(("advance_adaptive_kernel",),
                                           nsteps),
            "drydepo_t_below": per_launch(("drydepo_kernel",), nsteps),
            "quad_tables": per_launch(("quad_tables_kernel",), nsteps),
            "conccalc": per_launch(("conccalc_kernel",),
                                   launches["conccalc"]),
            "reorder": per_launch(SORT_KERNELS, sorts),
            "convection": per_launch(("convection_kernel",), nsteps + 1),
            "redist": per_launch(("redist_kernel",), nsteps + 1),
            "wetdepo": per_launch(("wetdepo_kernel",), nsteps),
            "depo_scatter": per_launch(("depo_grid_kernel",), 2 * nsteps)},
        top=[dict(name=k[:60], calls=c, ms=ms) for k, c, ms in rows[:10]],
        kernels_on_sim_adaptive_inputs=on_inputs)
    del sim
    shutil.rmtree(SIM_ADAPTIVE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


SIM_CBL_DIR = ROOT / "build" / "sim_cbl_smoke"
# sim_cbl's kept steps hold K11 CBL against its plain version on every
# SIM_CBL_STRIDE-th particle of the step in cell order (the plain CBL takes
# seconds at full width; the kernels phase holds it there once)
SIM_CBL_STRIDE = 8


def every_kth(p, k: int):
    """Every ``k``-th particle of ``p``, in its order, as a new ensemble."""
    from flexpart_tpu_torch.core.state import FIELDS, Particles
    return Particles(**{f: getattr(p, f)[::k].contiguous() for f in FIELDS})


def phase_sim_cbl(device, kernels) -> dict:
    """``Simulation.run`` with the skewed convective boundary layer on the
    card: sim_adaptive's two boxes with ``Command(cblflag=1, ctl=5)``
    (ifine 11, turbswitch, the adaptive step: K11's CBL instantiation with
    settling, as the aerosol box emits one species), 10 x 2**20 particles,
    3 h on SyntheticMet, twice with one seed (run_twice: bitwise equal
    particles and nan counts, the budget, the tracer's mass, the grids).
    Per step of run B: the share of the boundary-layer particles in the
    skewed zone (-h/L > 5) and K11's lane efficiency; on a release step
    and on a steady step (kept_steps) K11 CBL against its plain version
    (check_adaptive: bitwise, the passes, t_below, nan_count) on every
    SIM_CBL_STRIDE-th particle, and K11 CBL timed on all of them."""
    import copy
    import shutil
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    shutil.rmtree(SIM_CBL_DIR, ignore_errors=True)
    nsteps = SIM_ADAPTIVE_HOURS * 3600 // LSYNC
    keep, snaps, shares, lane_work = {}, {}, [], []

    def setup(run):
        sim = sim_adaptive_setup(SIM_CBL_DIR / run, device, False,
                                 cmd_kw=dict(cblflag=1))
        c = sim.step_cfg
        check(c.cblflag and c.method == 1 and c.turbswitch
              and c.ifine == CBL_IFINE and c.settling,
              f"sim_cbl: {c}")
        keep.update(kept_steps(sim, nsteps, "sim_cbl"))
        return sim

    def probe_fn(sim):
        def probe(istep, itime):
            z0, z1, mt0, mt1 = sim._fields_for(itime)
            tw = advance._time_weights(itime, mt0, mt1, sim.step_prm,
                                       sim.step_cfg)[:4]
            t = interp.build_step_tables_quad(
                z0, z1, *tw, dtype=sim.step_cfg.table_dtype)
            shares.append(skewed_share(sim.particles, z0.height, t,
                                       sim.step_cfg))
            if istep in keep:
                snaps[keep[istep]] = (istep, itime, sim.particles, z0, z1,
                                      mt0, mt1)
        return probe

    def wrap(inner):
        def counted(*args, **kw):
            p, diag = inner(*args, **kw)
            lane_work.append(diag.lane_work.clone())
            return p, diag
        return counted

    sim, rows, a = run_twice(setup, kernels, "sim_cbl", 1.0,
                             ADAPTIVE_PATH_KERNELS, None, probe_fn, wrap)
    launches = a["launches"]
    check(launches["advance_adaptive"] == nsteps and launches["advance"] == 0,
          f"sim_cbl: {launches} launches in {nsteps} steps")
    device_ms, per_launch = per_launch_of(rows)
    on_inputs = {}
    from flexpart_tpu_torch import _build
    ins = k11_instructions(_build.ADVANCE_ADAPTIVE, k11_entry(sim.step_cfg),
                           sim.step_cfg.ifine)
    for name, (istep, itime, p, z0, z1, mt0, mt1) in snaps.items():
        cfg, prm = sim.step_cfg, sim.step_prm
        q = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
        tw = advance._time_weights(itime, mt0, mt1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(z0, z1, *tw,
                                               dtype=cfg.table_dtype)
        ka = advance.advance_args(cfg, prm, itime, mt0, mt1)
        key = rng.Key(sim.seed, istep)
        settle = advance.settle_met(z0, cfg)
        sub = every_kth(q, SIM_CBL_STRIDE)
        r, pk, dk = check_adaptive(sub, z0.height, tables, ka, key, cfg,
                                   settle, f"sim_cbl {name} {istep}: K11 CBL",
                                   time_plain=True)
        r.update(istep=istep, checked=sub.capacity,
                 nan_count=int(dk.nan_count),
                 ms=cuda_ms(lambda: advance.advance_adaptive_cuda(
                     q, z0.height, tables, copy.copy(ka), key, cfg, None, 0,
                     settle), 5))
        del pk, dk, sub
        # the bound on all of the step's particles (kernel_advance_cbl's)
        pk, dk = advance.advance_adaptive_cuda(q, z0.height, tables,
                                               copy.copy(ka), key, cfg, None,
                                               0, settle)
        k11 = k11_bound(q, pk, dk.passes, z0.height, cfg, ka, ins)
        del pk, dk
        r.update(cbl_skewed_bound(k11, q, z0.height, tables, ka, key, cfg,
                                  itime, settle))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        on_inputs[name.replace(" ", "_")] = {
            f: r[f] for f in ("istep", "checked", "ms", "plain_ms",
                              "max_abs_err", "differing_particles",
                              "bitwise", "nan_count", "lane_efficiency",
                              "passes_mean", "passes_max", "bound_ms",
                              "bound_by", "bound_without_skewed_calls",
                              "skewed_calls", "skewed_instructions",
                              "share_of_bound")}
    check(len(on_inputs) == 2, f"sim_cbl: kept steps {list(on_inputs)}")
    check(max(shares) > 0.0, "sim_cbl: no boundary-layer particle skewed")
    snaps.clear()
    res = dict(
        n=N_MAIN, steps=nsteps, hours=SIM_ADAPTIVE_HOURS, **a,
        skewed_share_per_step=shares,
        lane_efficiency_per_step=[lane_efficiency(w)["lane_efficiency"]
                                  for w in lane_work],
        lane_efficiency_run=lane_efficiency(
            torch.stack(lane_work).sum(dim=0))["lane_efficiency"],
        nan_redraws_per_step=[int(w[2]) for w in lane_work],
        device_ms_all_kernels=device_ms,
        device_per_call={
            "advance_adaptive_cbl": per_launch(("advance_adaptive_kernel",),
                                               nsteps),
            # the probe builds the step's tables too: two builds a step
            "quad_tables": per_launch(("quad_tables_kernel",), 2 * nsteps)},
        kernels_on_sim_cbl_inputs=on_inputs)
    del sim
    shutil.rmtree(SIM_CBL_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


SIM_NESTED_DIR = ROOT / "build" / "sim_nested_smoke"
# sim_nested's nest: 0.25 degrees over 10 W - 20 E, 30 - 60 N, with the
# inner nest's jet of the kernels phase (the mother's: 25 m/s)
SIM_NEST = dict(dx=0.25, dy=0.25, xlon0=-10.0, ylat0=30.0, nx=121, ny=121)


def phase_sim_nested(device, kernels) -> dict:
    """``Simulation.run`` with a nested met grid on the card: the sim
    phase's configuration (the default Command, two species, convection)
    with one SyntheticMet nest of 0.25 degrees over 10 W-20 E, 30-60 N on
    the same 30 levels (121 x 121 columns) and a stronger jet than the
    mother's (NEST_U_JET); the first box lies inside it, the storm box
    outside.  Twice with one seed (run_twice); K2 runs once per grid per
    step (mother and nest), K4 in its NESTS instantiation.  Per step of
    run B the share of the particles the nest samples; on a release step
    and a steady step (kept_steps) K4 NESTS against its plain version,
    injected draws on both sides, every output bitwise, and its draws in
    registers against the injected ones."""
    import shutil
    import torch
    from flexpart_tpu_torch import SyntheticMet
    from flexpart_tpu_torch.core import advance, reorder, rng
    shutil.rmtree(SIM_NESTED_DIR, ignore_errors=True)
    nsteps = SIM_HOURS * 3600 // LSYNC
    keep, snaps, shares = {}, {}, []

    def setup(run):
        grid = nest_grid(make_sim_grid(), SIM_NEST)
        sim = sim_setup(SIM_NESTED_DIR / run, device, False,
                        met_nests=(SyntheticMet(
                            grid, u_jet=NEST_U_JET["inner"]),))
        check(sim.step_cfg.nests == ((grid.nx, grid.ny),)
              and sim.step_cfg.method == 0, f"sim_nested: {sim.step_cfg}")
        keep.update(kept_steps(sim, nsteps, "sim_nested"))
        return sim

    def probe_fn(sim):
        def probe(istep, itime):
            p = sim.particles
            a = advance.advance_args(sim.step_cfg, sim.step_prm, itime, 0,
                                     3600)
            idx = advance.nest_index(sim.step_cfg, a, p.x, p.y)
            shares.append(int((p.active & (idx >= 0)).sum())
                          / max(int(p.active.sum()), 1))
            if istep in keep:
                z0, z1, mt0, mt1 = sim._fields_for(itime)
                snaps[keep[istep]] = (istep, itime, p, z0, z1, mt0, mt1,
                                      sim._get_nest(mt0), sim._get_nest(mt1))
        return probe

    # the aerosol: one unit from each box
    sim, rows, a = run_twice(setup, kernels, "sim_nested", 2.0,
                             FIXED_PATH_KERNELS, None, probe_fn)
    launches = a["launches"]
    check(launches["advance"] == nsteps
          and launches["quad_tables"] == 2 * nsteps,
          f"sim_nested: {launches} launches in {nsteps} steps")
    check(max(shares) > 0.3, f"sim_nested: nest shares {shares}")
    device_ms, per_launch = per_launch_of(rows)
    on_inputs = {}
    for name, (istep, itime, p, z0, z1, mt0, mt1, zn0, zn1) in snaps.items():
        cfg, prm = sim.step_cfg, sim.step_prm
        q = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
        tw = advance._time_weights(itime, mt0, mt1, prm, cfg)[:4]
        tables = interp_tables(z0, z1, tw, cfg)
        tables_n = tuple(interp_tables(x, y, tw, cfg)
                         for x, y in zip(zn0, zn1))
        ka = advance.advance_args(cfg, prm, itime, mt0, mt1)
        key = rng.Key(sim.seed, istep)
        draws = {tag: rng.normals(key, (rows_, q.capacity), tag, 0,
                                  device=device)
                 for tag, rows_ in advance.draw_tags(cfg).items()}
        args = (q, z0.height, tables, ka, key, cfg)
        pk, _ = advance.advance_all_cuda(*args, draws, 0, tables_n=tables_n)
        pp, _ = advance.advance_all_plain(*args, draws, 0, tables_n=tables_n)
        torch.cuda.synchronize()
        what = f"sim_nested {name}: K4 NESTS"
        r = compare_particles(pk, pp, what, float(cfg.nx - 1))
        r.update(istep=istep, max_abs_err=max(r["max_dx"], r["max_dy"]),
                 differing_particles=differing_particles(
                     pk, pp, advance.OUT_FIELDS))
        check(r["differing_particles"] == 0, f"{what} differs from its plain "
              f"version in {r['differing_particles']} particles")
        check_same_bits(advance.advance_all_cuda(*args, None, 0,
                                                 tables_n=tables_n)[0], pk,
                        f"{what}, draws in registers vs injected")
        del pk, pp, draws
        r["ms"] = cuda_ms(lambda: advance.advance_all_cuda(
            *args, None, 0, tables_n=tables_n), 10)
        r["plain_ms"] = cuda_ms(lambda: advance.advance_all_plain(
            *args, None, 0, tables_n=tables_n), 2)
        on_inputs[name.replace(" ", "_")] = r
    check(len(on_inputs) == 2, f"sim_nested: kept steps {list(on_inputs)}")
    snaps.clear()
    res = dict(
        n=N_MAIN, steps=nsteps, hours=SIM_HOURS, nest=SIM_NEST,
        nest_u_jet=NEST_U_JET["inner"], **a, nest_share_per_step=shares,
        device_ms_all_kernels=device_ms,
        device_per_call={
            "advance_nests": per_launch(("advance_kernel",), nsteps),
            "quad_tables": per_launch(("quad_tables_kernel",), 2 * nsteps)},
        kernels_on_sim_nested_inputs=on_inputs)
    del sim
    shutil.rmtree(SIM_NESTED_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


# ------------------------------------------------ backward runs: kernels --

# the adaptive advance's backward checks (K11 and K11 CBL at ldirf = -1)
# take a tenth of the main path's particles: the plain versions take 0.7 s
# and 3 s at its full width, and K11 has been held at full width forward
N_BACKWARD_ADAPTIVE = 2 ** 20
# a backward step in the middle of a wind interval (the run's times count
# down from 0): its start and the two met times around it
BACK_ITIME, BACK_MEM0, BACK_MEM1 = -4500, -7200, -3600


def backward(cfg):
    """The same StepConfig with ldirect = -1 (AdvanceArgs.ldirf = -1)."""
    from flexpart_tpu_torch.core.advance import StepConfig
    return StepConfig(**{**cfg.__dict__, "ldirect": -1})


def kernel_advance_backward(device, grid) -> dict:
    """The advance of a backward run (ldirect = -1: AdvanceArgs.ldirf = -1
    reverses the displacement, the Langevin equation's time direction and
    the z update; the end time lies before itime) against the plain
    advance, every output bitwise: stock K4 and its POLAR instantiation on
    10 x 2**20 particles with K1's draws injected (edge_particles, which
    enter every branch, and sphere_particles over both caps), each timed in
    cell order beside the forward instantiation on the same particles; K11
    (settling, as sim_adaptive) and K11 CBL (as sim_cbl, on convective_met)
    on N_BACKWARD_ADAPTIVE boundary-layer particles with their draws made
    in registers (check_adaptive).  The particles must move otherwise than
    forward."""
    import copy
    import torch
    from flexpart_tpu_torch.core import advance, interp, reorder, rng
    z0, z1 = met_fields("synthetic", grid, device, (0.0, 10800.0))
    itime, mem0, mem1 = BACK_ITIME, BACK_MEM0, BACK_MEM1
    key = rng.Key(4321, 21)
    res = {}
    for name, kw in (("stock", {}), ("polar", {"polar": True})):
        fwd, prm, *_ = step_setup(grid, **kw)
        cfg = backward(fwd)
        tw = advance._time_weights(itime, mem0, mem1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(z0, z1, *tw,
                                               dtype=cfg.table_dtype)
        a = advance.advance_args(cfg, prm, itime, mem0, mem1)
        a_fwd = advance.advance_args(fwd, prm, itime, mem0, mem1)
        check(a.ldirf == -1.0 and a_fwd.ldirf == 1.0 and a.itra_new < itime,
              f"K4 {name} backward: ldirf {a.ldirf}, end {a.itra_new}")
        if name == "stock":
            p = edge_particles(N_MAIN, device, 51, itime, lambda q: sample_met(
                q, z0.height, tables, cfg)[0])
        else:
            p = sphere_particles(N_MAIN, device, 52, itime, grid.nx, grid.ny)
        draws = {tag: rng.normals(key, (rows, N_MAIN), tag, device=device)
                 for tag, rows in {**advance.DRAW_ROWS, 2: cfg.ifine}.items()}

        def run(q, d=None, args=a, c=cfg):
            return advance.advance_all_cuda(q, z0.height, tables, args, key,
                                            c, d, 0)

        (pk, _), (pp, _) = run(p, draws), advance.advance_all_plain(
            p, z0.height, tables, a, key, cfg, draws, 0)
        torch.cuda.synchronize()
        r = compare_particles(pk, pp, f"K4 {name} backward",
                              float(grid.nx - 1))
        differ = differing_particles(pk, pp, advance.OUT_FIELDS)
        check(differ == 0, f"K4 {name} backward differs from its plain "
              f"version in {differ} particles")
        check_same_bits(run(p)[0], pk, f"K4 {name} backward: draws in "
                        "registers vs injected")
        fw = run(p, draws, a_fwd, fwd)[0]
        both = p.active & pk.active & fw.active
        apart = float((pk.x - fw.x)[both].abs().mean())
        check(apart > 0.0, f"K4 {name} backward moves as forward")
        del pk, pp, fw, draws
        q = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
        r.update(differing_particles=differ, bitwise=True, n=N_MAIN,
                 mean_x_apart_from_forward=apart,
                 max_abs_err=max(r["max_dx"], r["max_dy"]),
                 ms=cuda_ms(lambda: run(q), 10),
                 forward_ms=cuda_ms(lambda: run(q, None, a_fwd, fwd), 10),
                 plain_ms=cuda_ms(lambda: advance.advance_all_plain(
                     q, z0.height, tables, a, key, cfg, None, 0), 2))
        res[f"advance_{name}"] = r
        del p, q, tables
        torch.cuda.empty_cache()

    for name, conv in (("adaptive", False), ("adaptive_cbl", True)):
        zz0, zz1 = ((convective_met(z, grid.nx // 2) for z in (z0, z1))
                    if conv else (z0, z1))
        fwd, prm = (cbl_params(grid) if conv else settling_params(
            grid, turbswitch=True, ifine=4, method=1, settling=True,
            polar=True))
        cfg = backward(fwd)
        tw = advance._time_weights(itime, mem0, mem1, prm, cfg)[:4]
        tables = interp.build_step_tables_quad(zz0, zz1, *tw,
                                               dtype=cfg.table_dtype)
        a = advance.advance_args(cfg, prm, itime, mem0, mem1)
        a_fwd = advance.advance_args(fwd, prm, itime, mem0, mem1)
        settle = advance.settle_met(zz0, cfg) if cfg.settling else None
        p = boundary_layer_particles(N_BACKWARD_ADAPTIVE, device, 53, grid,
                                     itime, lambda q: sample_met(
                                         q, zz0.height, tables, cfg)[0])
        q = reorder.reorder_by_cell_cuda(p, zz0.height, cfg)[0]
        r, pk, dk = check_adaptive(q, zz0.height, tables, a, key, cfg, settle,
                                   f"K11 {name} backward", time_plain=True)
        check(int(dk.passes.sum()) > 0, f"K11 {name} backward: no pass")

        def run(args, c):
            return advance.advance_adaptive_cuda(
                q, zz0.height, tables, copy.copy(args), key, c, None, 0,
                settle)

        fw = run(a_fwd, fwd)[0]
        both = pk.active & fw.active
        check(bool(((pk.x - fw.x).abs() > 0)[both].any()),
              f"K11 {name} backward moves as forward")
        r.update(n=N_BACKWARD_ADAPTIVE, nan_count=int(dk.nan_count),
                 ms=cuda_ms(lambda: run(a, cfg), 5),
                 forward_ms=cuda_ms(lambda: run(a_fwd, fwd), 5))
        res[name] = r
        del p, q, pk, dk, fw, tables
        torch.cuda.empty_cache()
    return res


def backward_conccalc_particles(device, nspec: int = 2):
    """The K3 phase's steady ensemble (old particles, cell order) with
    ``nspec`` species and scavenging factors in [-0.5, 2): a fifth of them
    negative, which a backward deposition run samples as 0."""
    import torch
    from flexpart_tpu_torch.core import reorder
    p = bench_particles(N_MAIN, device, seed=7, old_fraction=1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(71)
    mass = torch.rand((N_MAIN, nspec), generator=gen, device=device) / N_MAIN
    xscav = torch.rand((N_MAIN, nspec), generator=gen,
                       device=device) * 2.5 - 0.5
    p = p.replace(itra=torch.full_like(p.itra, 14400),
                  itramem=p.itramem + 14400 - 3600, mass=mass,
                  mass0=mass.clone(), xscav=xscav)
    return p


def kernel_conccalc_backward(device, grid) -> dict:
    """K3's BKDEP instantiation (each species' value times max(xscav, 0))
    and its COUNT instantiation (the particle count: 1, or the 4-point
    weight) against conccalc_plain on 10 x 2**20 old particles with two
    species in cell order, both sampling paths, within K3_RTOL (float
    atomics); timed on the steady step's path (4-point) beside the stock
    instantiation on the same particles, with index_add_ of each one's own
    valid pairs as the library call (the scatter half)."""
    import torch
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.grid import conccalc as cc
    from flexpart_tpu_torch.grid.outgrid import zero_accumulators
    cfg, _, og, geo, ccfg = step_setup(grid)
    (z0,) = met_fields("synthetic", grid, device)
    nspec = 2
    p = reorder.reorder_by_cell_cuda(backward_conccalc_particles(device,
                                                                 nspec),
                                     z0.height, cfg)[0]
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=device)
    gk = zero_accumulators(geo, nspec, 1, device=device).gridunc
    gp = torch.zeros_like(gk)
    rows = gk.numel() // nspec
    res = {}
    for name, flags in (("conccalc.bkdep", dict(bkdep=True)),
                        ("conccalc.count", dict(particle_count_output=True))):
        cases = {}
        for kp in (False, True):
            c = ccfg.replace(kernel_possible=kp, **flags)
            args = (p, 14400, lage, oh, 1.0, None, c)
            what = f"K3 {name} {'4-point' if kp else 'single-index'} path"
            gk.zero_()
            gp.zero_()
            cc.conccalc_cuda(gk.view(-1, nspec), *args)
            cc.conccalc_plain(gp.view(-1, nspec), *args)
            d = (gk - gp).abs()
            check(bool(torch.all(d <= K3_RTOL * gp.abs())),
                  f"{what} exceeds rtol {K3_RTOL}: max abs {float(d.max())}")
            check(float(gp.sum()) > 0.0, f"{what}: nothing sampled")
            lin, valid, contrib = cc.conccalc_pairs(rows, *args)
            lin_v, con_v = lin[valid], contrib[valid]
            del lin, valid, contrib
            flat_l = torch.zeros_like(gk.view(-1, nspec))
            case = dict(max_abs_err=float(d.max()), pairs=int(lin_v.numel()),
                        library_ms=cuda_ms(
                            lambda: flat_l.index_add_(0, lin_v, con_v), 10),
                        ms=cuda_ms(lambda: cc.conccalc_cuda(
                            gk.view(-1, nspec), *args), 10),
                        stock_ms_same_particles=cuda_ms(
                            lambda: cc.conccalc_cuda(
                                gk.view(-1, nspec), *args[:-1],
                                c.replace(bkdep=False,
                                          particle_count_output=False)), 10),
                        plain_ms=cuda_ms(lambda: cc.conccalc_plain(
                            gp.view(-1, nspec), *args), 3))
            del lin_v, con_v, flat_l
            cases["kernel" if kp else "single"] = case
        m = cases["kernel"]
        # 37 B of particle state and the mass (4 B a species) in, BKDEP's
        # xscav (4 B a species); COUNT reads no mass; the grid read and
        # written once (atomics on top are not counted)
        per = 37 + (8 * nspec if name.endswith("bkdep") else 0)
        res[name] = dict(
            {f: m[f] for f in ("ms", "plain_ms", "library_ms",
                               "stock_ms_same_particles")},
            max_abs_err=max(c["max_abs_err"] for c in cases.values()),
            cases=cases, n=N_MAIN, nspec=nspec,
            **bound(per * N_MAIN + 2 * 4 * gk.numel(),
                    K3_OPS_PER_PARTICLE * N_MAIN))
    return res


def bkdep_particles(p, device, seed: int):
    """p with scavenging factors of a backward deposition run: half the
    active particles fresh (xscav = -1, to be assigned), the rest 0.5."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    fresh = torch.rand(p.capacity, generator=gen, device=device) < 0.5
    xs = torch.where(fresh[:, None], -1.0, 0.5).expand(-1, p.nspec)
    return p.replace(xscav=xs.contiguous())


def kernel_bkdep(device, grid) -> dict:
    """K9's and K10's BKDEP instantiations (the scavenging factor of a
    backward deposition run's fresh particles) against their plain
    versions on the deposition phase's 10 x 2**20 particles with two
    species, half of them fresh, in cell order: mass and xscav bitwise.
    K9 BKDEP on SyntheticMet's fields and with every cloud class (some
    factors must be positive, some masses zeroed); K10 BKDEP on a velocity
    field of which a tenth is not positive (some masses zeroed)."""
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.physics import bkdep as bk
    from flexpart_tpu_torch.physics import wetdepo as wd
    cfg = step_setup(grid)[0]
    species = depo_species()
    wet = tuple(wd.WetSpecies.from_species(s) for s in species)
    (z0,) = met_fields("synthetic", grid, device, (3600.0,))
    fields = {"synthetic": z0, "all_classes": all_classes_met(z0, device, 21)}
    p = bkdep_particles(depo_particles(N_MAIN, device, 23, grid), device, 24)
    q = reorder.reorder_by_cell_cuda(p, z0.height, cfg)[0]
    del p
    fresh = q.active & (q.xscav[:, 0] < 0)
    n_fresh = int(fresh.sum())

    def held(k, pl, what):
        # bitwise: bits_or_close with no tolerance
        out = {f: bits_or_close(getattr(k, f), getattr(pl, f), 0.0,
                                f"{what}: {f}") for f in ("mass", "xscav")}
        return dict(max_abs_err=max(v["max_abs_err"] for v in out.values()),
                    zeroed=int(((pl.mass == 0) & (q.mass != 0)).any(1).sum()),
                    positive=int((fresh[:, None] & (pl.xscav > 0)).sum()))

    k9 = {}
    for fname, zf in fields.items():
        what = f"K9 BKDEP {fname}"
        k, pl = (bk.assign_wetbkdep_cuda(q, zf, wet),
                 bk.assign_wetbkdep_plain(q, zf, wet))
        torch.cuda.synchronize()
        r = held(k, pl, what)
        check(bool((k.xscav[fresh] >= 0).all()), f"{what}: a factor < 0")
        check(r["positive"] > 0 and r["zeroed"] > 0, f"{what}: {r}")
        r.update(ms=cuda_ms(lambda: bk.assign_wetbkdep_cuda(q, zf, wet), 10),
                 plain_ms=cuda_ms(lambda: bk.assign_wetbkdep_plain(
                     q, zf, wet), 3),
                 k9_ms_same_particles=cuda_ms(lambda: wd.wetdepo_cuda(
                     q, zf, LSYNC, 2700, wet, bk.MassSpecies(
                         decay=(0.0, 0.0), drydep=(False, False))), 10))
        k9[fname] = r
        del k, pl
    # bytes: active, mass and xscav in and out of every particle, the
    # positions of the fresh ones, z of the fresh ones it rains on, the
    # three surface planes it reads (lsp, convp, tcc), the cloud classes,
    # the temperature and the heights; operations: the BKDEP section's own
    # code per particle and each rule's per call
    nz, ny, nx = z0.clouds.shape
    entry = sass_instantiation(_build.WETDEPO, "wetdepo_kernel",
                               (True, False))[0]
    paths = tuple(f for f in K9_PATHS if f != "wet_removal")
    ins = sass_paths(_build.WETDEPO, paths, within=entry)
    calls = k9_path_calls(q.replace(active=fresh), z0, wet,
                          bk.MassSpecies(decay=(0.0, 0.0),
                                         drydep=(False, False)))
    n_ops = ins["kernel"] * N_MAIN + sum(ins[f] * calls[f] for f in paths)
    k9_out = dict(k9["synthetic"], cases=k9, instructions=ins,
                  path_calls=calls, n=N_MAIN, fresh=n_fresh, library_ms=None,
                  bitwise=True,
                  max_abs_err=max(c["max_abs_err"] for c in k9.values()),
                  **bound(N_MAIN * (1 + 16 * 2) + 16 * n_fresh
                          + 4 * calls["active_raining"] + 12 * ny * nx
                          + 5 * nz * ny * nx + 4 * nz, n_ops))

    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    vdep = torch.rand((2, grid.ny, grid.nx), generator=gen,
                      device=device) * 0.022 - 0.002
    what = "K10 BKDEP"
    k, pl = (bk.assign_drybkdep_cuda(q, vdep),
             bk.assign_drybkdep_plain(q, vdep))
    torch.cuda.synchronize()
    r = held(k, pl, what)
    check(r["positive"] > 0 and r["zeroed"] > 0, f"{what}: {r}")
    del k, pl
    k10_out = dict(
        r, n=N_MAIN, fresh=n_fresh, library_ms=None, bitwise=True,
        ms=cuda_ms(lambda: bk.assign_drybkdep_cuda(q, vdep), 10),
        plain_ms=cuda_ms(lambda: bk.assign_drybkdep_plain(q, vdep), 3),
        # active, mass and xscav in and out, the positions of the fresh
        # particles; the velocities
        **bound(N_MAIN * (1 + 16 * 2) + 16 * n_fresh
                + 4 * 2 * grid.ny * grid.nx,
                # the weights and each species' gather, fresh particles only
                n_fresh * (K10_OPS_PER_PARTICLE + 10 * 2)))
    return {"wetdepo.bkdep": k9_out, "drydepo.bkdep": k10_out}


def clwc_all_classes_met(zf, device, seed: int):
    """all_classes_met's fields with a column cloud water: ctwc of 0.05-2
    kg/m2 in every column that holds an in-cloud cell (class 2 or 3), but
    in a tenth of them, which keep 0 (the plain version's 1e-30 floor of
    the aerosol rule), from a seed."""
    import torch
    from flexpart_tpu_torch.met.fields import F2_CTWC
    zf = all_classes_met(zf, device, seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    ny, nx = zf.clouds.shape[1:]
    incl = ((zf.clouds == 2) | (zf.clouds == 3)).any(dim=0)
    keep = torch.rand((ny, nx), generator=gen, device=device) >= 0.1
    water = torch.rand((ny, nx), generator=gen, device=device) * 1.95 + 0.05
    f2d = zf.f2d.clone()
    f2d[F2_CTWC] = torch.where(incl & keep, water, torch.zeros_like(water))
    return zf.replace(f2d=f2d)


def kernel_clwc(device, grid) -> dict:
    """K9's CLWC instantiations against their plain versions on the
    deposition phase's 10 x 2**20 particles with two species: K9 CLWC
    (wetscav_all_plain(..., True) + apply_wetdepo_plain) on SyntheticMet's
    fields classified by their cloud water (use_clwc: the readclouds
    classes and the column cloud water ctwc) and on every cloud class with
    a seeded ctwc plane (clwc_all_classes_met), as drawn and in cell order;
    K9 BKDEP x CLWC (assign_wetbkdep_plain(..., use_clwc=True)) on both in
    cell order, half the particles fresh: all bitwise.  Each timed beside
    K9 (K9 BKDEP) on the same particles and fields, with its bound from the
    compiled CLWC section's instructions; the in-cloud rule must scavenge
    on both fields."""
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.physics import bkdep as bk
    from flexpart_tpu_torch.physics import massupdate as mu
    from flexpart_tpu_torch.physics import wetdepo as wd
    cfg = step_setup(grid)[0]
    species = depo_species()
    wet = tuple(wd.WetSpecies.from_species(s) for s in species)
    msp = mu.MassSpecies(decay=tuple(s.decay for s in species),
                         drydep=tuple(s.drydep for s in species))
    (zc,) = met_fields("synthetic_clwc", grid, device, (3600.0,))
    fields = {"synthetic_clwc": zc,
              "all_classes": clwc_all_classes_met(zc, device, 21)}
    p = depo_particles(N_MAIN, device, 23, grid)
    orders = {"as_drawn": p,
              "cell_ordered": reorder.reorder_by_cell_cuda(p, zc.height,
                                                           cfg)[0]}
    del p
    ldeltat = 2700
    ins = k9_instructions(clwc=True)
    cases = {}
    for oname, q in orders.items():
        for fname, zf in fields.items():
            what = f"K9 CLWC {fname}, {oname}"
            r = check_wetdepo(q, zf, wet, msp, ldeltat, what, clwc=True)
            r.pop("deposit")
            check(r["bitwise"], f"{what}: not bitwise")
            r.update(k9_bound(q, zf, wet, msp, ins, clwc=True))
            calls = r["path_calls"]
            check(calls["lam_in_cloud_aerosol"] > 0
                  and calls["cloud_water_column"] > 0,
                  f"{what}: no in-cloud scavenging: {calls}")
            r["ms"] = cuda_ms(lambda: wd.wetdepo_cuda(
                q, zf, LSYNC, ldeltat, wet, msp, True), 10)
            r["k9_ms_same_particles"] = cuda_ms(lambda: wd.wetdepo_cuda(
                q, zf, LSYNC, ldeltat, wet, msp), 10)
            r["plain_ms"] = cuda_ms(lambda: mu.apply_wetdepo_plain(
                q, *wd.wetscav_all_plain(q, zf, wet, True), LSYNC, ldeltat,
                msp), 3)
            cases[f"{fname}_{oname}"] = r
    main = cases["synthetic_clwc_cell_ordered"]
    clwc = dict(
        {f: main[f] for f in ("ms", "plain_ms", "k9_ms_same_particles",
                              "bound_ms", "bound_by", "bound_bytes",
                              "bound_operations", "path_calls",
                              "scavenged_share")},
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        bitwise=True, library_ms=None, ms_case="synthetic_clwc_cell_ordered",
        unordered_ms=cases["synthetic_clwc_as_drawn"]["ms"],
        instructions=ins, n=N_MAIN,
        cases={n: {f: c[f] for f in ("ms", "plain_ms",
                                     "k9_ms_same_particles", "bound_ms",
                                     "max_abs_err", "scavenged_share")}
               for n, c in cases.items()})
    del orders
    torch.cuda.empty_cache()

    # BKDEP x CLWC: the scavenging factor of a WETBKDEP run's fresh
    # particles with the column cloud water, cell order
    q = bkdep_particles(reorder.reorder_by_cell_cuda(
        depo_particles(N_MAIN, device, 23, grid), zc.height, cfg)[0],
        device, 24)
    fresh = q.active & (q.xscav[:, 0] < 0)
    bcases = {}
    for fname, zf in fields.items():
        what = f"K9 BKDEP x CLWC {fname}"
        k = bk.assign_wetbkdep_cuda(q, zf, wet, use_clwc=True)
        pl = bk.assign_wetbkdep_plain(q, zf, wet, use_clwc=True)
        torch.cuda.synchronize()
        out = {f: bits_or_close(getattr(k, f), getattr(pl, f), 0.0,
                                f"{what}: {f}") for f in ("mass", "xscav")}
        r = dict(max_abs_err=max(v["max_abs_err"] for v in out.values()),
                 positive=int((fresh[:, None] & (pl.xscav > 0)).sum()),
                 zeroed=int(((pl.mass == 0) & (q.mass != 0)).any(1).sum()))
        check(r["positive"] > 0 and r["zeroed"] > 0, f"{what}: {r}")
        del k, pl
        r.update(
            ms=cuda_ms(lambda: bk.assign_wetbkdep_cuda(
                q, zf, wet, use_clwc=True), 10),
            k9_bkdep_ms_same_particles=cuda_ms(
                lambda: bk.assign_wetbkdep_cuda(q, zf, wet), 10),
            plain_ms=cuda_ms(lambda: bk.assign_wetbkdep_plain(
                q, zf, wet, use_clwc=True), 3))
        bcases[fname] = r
    # bytes: K9 BKDEP's (kernel_bkdep) and the column cloud water of each
    # fresh particle in cloud; operations: the BKDEP x CLWC section's own
    # code per particle and each rule's per call
    nz, ny, nx = zc.clouds.shape
    entry = sass_instantiation(_build.WETDEPO, "wetdepo_kernel",
                               (True, True))[0]
    paths = tuple(f for f in K9_CLWC_PATHS if f != "wet_removal")
    bins = sass_paths(_build.WETDEPO, paths, within=entry)
    calls = k9_path_calls(q.replace(active=fresh), zc, wet, msp, clwc=True)
    n_fresh = int(fresh.sum())
    bkdep_clwc = dict(
        bcases["synthetic_clwc"], cases=bcases, instructions=bins,
        path_calls=calls, n=N_MAIN, fresh=n_fresh, library_ms=None,
        bitwise=True,
        max_abs_err=max(c["max_abs_err"] for c in bcases.values()),
        **bound(N_MAIN * (1 + 16 * 2) + 16 * n_fresh
                + 4 * calls["active_raining"]
                + 4 * calls["cloud_water_column"] + 12 * ny * nx
                + 5 * nz * ny * nx + 4 * nz,
                bins["kernel"] * N_MAIN + sum(bins[f] * calls[f]
                                              for f in paths)))
    del q, fresh
    torch.cuda.empty_cache()
    return {"wetdepo.clwc": clwc, "wetdepo.bkdep_clwc": bkdep_clwc}


# -------------------------------------------- backward runs: Simulation --

# ------------------------------------------------- OH chemistry, splitting --

OH_DATE = (2020, 7, 1)     # the sim_oh_split phase's day: OH at 40 N
OH_ITIME = 11 * 3600 + 900  # a daylight step at 0-30 E


def oh_species():
    """The OH-reactive species of the kernels phase: the REACT species of
    the JAX package's own test (tests/test_physics.py:139: C = 1e-11, D =
    500, N = 0) and one with N = 2, so that the power is taken."""
    from flexpart_tpu_torch.config import Species
    return (Species(name="REACT", ohcconst=1.0e-11, ohdconst=500.0,
                    ohnconst=0.0),
            Species(name="REACT-N2", ohcconst=1.0e-17, ohdconst=300.0,
                    ohnconst=2.0))


def timed_in_place(make, fn, reps: int = 5) -> float:
    """Mean device ms of fn(make()) for a function that changes its input:
    each call on a fresh copy, only the call between the events."""
    import torch
    fn(make())
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        x = make()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(x)
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def graph_in_place_ms(restore, fn, reps: int = 10) -> float:
    """Device ms of fn() for a function that changes its input: ``reps``
    times (restore(); fn()) captured into one CUDA graph and replayed, less
    ``reps`` restore() alone replayed, per call (the two graphs timed
    alone, both, both, alone).  The host never stands between the
    launches."""
    import torch
    restore()
    fn()
    torch.cuda.synchronize()
    both, alone = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    # thread_local: a Simulation's met reader thread may use the card
    # while the graph is captured
    with torch.cuda.graph(both, capture_error_mode="thread_local"):
        for _ in range(reps):
            restore()
            fn()
    with torch.cuda.graph(alone, capture_error_mode="thread_local"):
        for _ in range(reps):
            restore()
    t = [cuda_ms(g.replay, 3) for g in (alone, both, both, alone)]
    restore()
    del both, alone
    return ((t[1] + t[2]) - (t[0] + t[3])) / (2 * reps)


def kernel_rows(prof, reps: int) -> dict:
    """A profile's device rows per call: {kernel (its namespace and
    arguments left out): {launches, ms}}."""
    out = {}
    for key, calls, ms in device_rows(prof):
        name = key.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].strip() or key
        name = name[len("void "):] if name.startswith("void ") else name
        row = out.setdefault(name, dict(launches=0.0, ms=0.0))
        row["launches"] += calls / reps
        row["ms"] += ms / reps
    return out


def profiled_in_place(make, fn, reps: int = 3) -> dict:
    """The device time of fn(x) by torch.profiler, each x = make() made
    before the profiled window (so its copies are not counted), after a
    warm-up call inside a discarded first step of the profiler (whose
    first events can be lost): ms per call over every kernel and memset
    fn launches, and per kernel its launches and ms per call.  Device
    times to compare come from graph_in_place_ms; this is the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn(make())
    torch.cuda.synchronize()
    # a window that lost events (a kernel's launches not a whole number a
    # call, or none) is taken again, up to three times
    for _ in range(3):
        xs = [make() for _ in range(reps + 1)]
        torch.cuda.synchronize()
        # the active step ends with the window, which keeps its events (a
        # step() at its end would clear them)
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1)) as prof:
            fn(xs[0])
            torch.cuda.synchronize()
            prof.step()
            for x in xs[1:]:
                fn(x)
            torch.cuda.synchronize()
        per = kernel_rows(prof, reps)
        del xs, prof
        if per and all(r["launches"] == round(r["launches"])
                       for r in per.values()):
            break
    return dict(device_ms=sum(r["ms"] for r in per.values()),
                launches_per_call=sum(r["launches"] for r in per.values()),
                per_launch=per)


def graph_on_copy_ms(p, fn, reps: int = 10) -> float:
    """graph_in_place_ms of fn(q) for a function that changes the
    particles q in place: q a working copy of ``p``, restored from ``p``
    (every field copied) before each call."""
    from flexpart_tpu_torch.core.state import FIELDS
    work = clone_particles(p)

    def restore():
        for f in FIELDS:
            getattr(work, f).copy_(getattr(p, f))

    ms = graph_in_place_ms(restore, lambda: fn(work), reps)
    del work
    return ms


def sectors(idx, width: int) -> int:
    """The 32-byte sectors that the elements ``idx`` of an array of
    ``width``-byte elements lie in (an element may straddle two)."""
    import torch
    first = idx.long() * width
    return int(torch.unique(torch.cat((first // 32,
                                       (first + width - 1) // 32))).numel())


def sector_bound(coalesced_bytes: float, n_sectors: int) -> dict:
    """The least time by sectors: the bytes read or written in order once,
    every scattered access a 32-byte sector of its own (each sector of an
    access set once), over the memory rate."""
    n = coalesced_bytes + 32 * n_sectors
    return dict(bound_sectors_ms=n / HBM_BYTES_PER_S * 1e3,
                bound_sector_bytes=int(n))


def slot_reads(p, needs) -> tuple:
    """The bytes and the 32-byte sectors of the reads of particle slots
    that a function needs: ``needs`` holds (mask, widths), the widths of
    the fields read at the slots of the mask.  Returns (bytes, sectors),
    each access set by its distinct sectors."""
    import torch
    n_bytes = n_sectors = 0
    for mask, widths in needs:
        idx = torch.nonzero(mask).flatten()
        for w in widths:
            n_bytes += w * int(idx.numel())
            n_sectors += sectors(idx, w)
    return n_bytes, n_sectors


def k13_bounds(p, itime: int, ldirect: int, origin_given: bool, parents,
               children) -> dict:
    """K13's least time on one call on the particles ``p``, by bytes and by
    sectors.  Of the slots it needs every active flag (in order), a live
    one's itrasplit, a dead one's itra and, where that is scheduled, its
    itramem, and the int64 origin of a due or free one (where an origin
    is given).  A granted pair reads its parent's fields, writes them to
    the child, and writes the parent's mass and split time.  Sectors: the
    active flags' bytes once; per access set of the slots and of the pairs
    (``parents``, ``children``: slot indices) its distinct sectors: the
    parents' 17 four-byte fields, cbt and three rows read, mass and
    itrasplit written; the children's 17 four-byte fields, cbt, active and
    three rows written (45 a pair where each lies alone)."""
    from flexpart_tpu_torch.core import split as sp
    from flexpart_tpu_torch.core.state import ITRA_INACTIVE
    due, free = sp.due_and_free(p, itime, ldirect)
    n, nspec = p.capacity, p.nspec
    dead = ~p.active
    read_b, read_s = slot_reads(p, (
        (p.active, (4,)), (dead, (4,)),
        (dead & (p.itra != ITRA_INACTIVE), (4,)),
        *(((due | free, (8,)),) if origin_given else ())))
    granted = int(parents.numel())
    per_pair = 2 * (69 + 12 * nspec) + 4 * nspec + 4
    row = 4 * nspec
    s4p, s1p, srp = (sectors(parents, w) for w in (4, 1, row))
    s4c, s1c, src = (sectors(children, w) for w in (4, 1, row))
    n_sectors = (17 * s4p + s1p + 3 * srp + srp + s4p
                 + 17 * s4c + 2 * s1c + 3 * src)
    return {**bound(n + read_b + granted * per_pair, 0),
            **sector_bound(n, read_s + n_sectors)}


def k14_bounds(p, origin_given: bool, bs, nz: int, nyx: int, md: int,
               check_x: bool, killed, born) -> dict:
    """K14's least time on one call on the particles ``p``, by bytes and by
    sectors.  Of the slots it needs every active flag (in order), a live
    one's y (and x where the window is checked in x; hi and lo each), a
    dead one's itra and, where that is scheduled, its itramem, and the
    int64 origin of a free one, the killed ones included (where an origin
    is given); it writes a killed slot's active and itra.  Of the sites
    their 15 table entries (58 B) and accumulator, read and written once;
    the gathers of the wind and density at both met times (16; the PV's
    8 more with MDOMAINFILL 2); a new particle's fields (70 + 8 nspec B).
    Sectors: the active flags and the sites' table once; per access set
    of the slots, of the gathers and of the killed and the new particles
    (``killed``, ``born``: slot indices: their 17 four-byte fields, cbt,
    active, mass and mass0 rows) its distinct sectors (the PV's gathers by
    their bytes)."""
    import torch
    from flexpart_tpu_torch.core import domainfill as df
    from flexpart_tpu_torch.core.state import ITRA_INACTIVE
    n, nspec, s = p.capacity, p.nspec, bs.sites
    dead = ~p.active
    freed = dead & ((p.itra == ITRA_INACTIVE) | (p.itra != p.itramem))
    freed[killed] = True
    read_b, read_s = slot_reads(p, (
        (p.active, (4, 4, 4, 4) if check_x else (4, 4)), (dead, (4,)),
        (dead & (p.itra != ITRA_INACTIVE), (4,)),
        *(((freed, (8,)),) if origin_given else ())))
    fidx = torch.where(bs.is_we, df.F3_U, df.F3_V).long()
    kz = bs.kz.long()
    col = bs.col_flat.long()
    gathers = torch.cat([(f * nz + kz + dk) * nyx + col
                         for f in (fidx, torch.full_like(fidx, df.F3_RHO))
                         for dk in (0, 1)])
    row = 4 * nspec
    n_killed, granted = int(killed.numel()), int(born.numel())
    pv = s * 32 if md == 2 else 0
    n_sectors = (read_s + 2 * sectors(gathers, 4)
                 + sectors(killed, 1) + sectors(killed, 4)
                 + 17 * sectors(born, 4) + 2 * sectors(born, 1)
                 + 2 * sectors(born, row))
    n_bytes = (n + read_b + s * (58 + 4 * 16 + 4) + pv + n_killed * 5
               + granted * (70 + 8 * nspec))
    return {**bound(n_bytes, s * (K14_OPS_PER_SITE
                                  + df.KMAX_EMIT * K14_OPS_PER_WISH)),
            **sector_bound(n + s * (58 + 4) + pv, n_sectors)}


def boundcond_call_bounds(before, after, args) -> dict:
    """k14_bounds of one boundcond call from the particles ``before`` it to
    those ``after`` it, ``args`` its arguments after the particles (bs, f0,
    f1, height, itime, ..., mdomainfill, ldirect, nclassunc, check_x,
    origin): the killed slots those live ones outside the window, the new
    particles those live after it in a dead or killed slot."""
    import torch
    bs, f0 = args[0], args[1]
    md, check_x, origin = args[12], args[15], args[16]
    _, xlo, xhi, ylo, yhi = bs.limits()
    x, y = before.x, before.y
    outside = (y < ylo) | (y > yhi)
    if check_x:
        outside = outside | (x < xlo) | (x > xhi)
    killed = before.active & outside
    born = after.active & (~before.active | killed)
    return k14_bounds(before, origin is not None, bs, f0.shape[1],
                      f0.shape[2] * f0.shape[3], md, check_x,
                      torch.nonzero(killed).flatten(),
                      torch.nonzero(born).flatten())


def kernel_ohreaction(device, grid) -> dict:
    """K12 against its plain version on the deposition phase's 10 x 2**20
    particles with the two OH species, at a daylight step of OH_DATE
    (hourly fields of the synthetic climatology), SyntheticMet's
    temperature: as drawn and in cell order, bitwise; some mass must be
    lost.  Its layout (shared bytes, blocks per SM, registers) from
    fp_ohreaction_layout."""
    import ctypes
    from datetime import datetime
    import torch
    from flexpart_tpu_torch import _build
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.met.fields import F3_TT
    from flexpart_tpu_torch.physics import ohchem
    cfg = step_setup(grid)[0]
    zf = met_fields("synthetic", grid, device)[0]
    field = ohchem.synthetic_oh_field()
    hourly = ohchem.HourlyOH(field, datetime(*OH_DATE), 1, device=device)
    oh0, oh1, t0, t1 = hourly.fields_for(OH_ITIME)
    species = oh_species()
    fn = ohchem.make_ohreaction(field, grid, species, device)
    g = fn.grid
    tt = zf.f3d[F3_TT]
    args = (oh0, oh1, t0, t1, OH_ITIME, tt, zf.height, LSYNC)
    p = depo_particles(N_MAIN, device, 29, grid, nspec=2)
    ps, _ = reorder.reorder_by_cell(p, zf.height, cfg)
    res, cases = {}, {}
    n = p.capacity
    for name, q in (("as_drawn", p), ("cell_order", ps)):
        k = fn(q, *args)
        pl = ohchem.ohreaction_plain(q, g, *args)
        check_same_bits(k, pl, f"K12 {name}", ("mass",))
        lost = (q.mass.double().sum(0) - k.mass.double().sum(0)).tolist()
        check(lost[0] > 0.0 and lost[1] > 0.0,
              f"K12 {name}: no OH loss {lost}")
        cases[name] = dict(
            ms=cuda_ms(lambda: fn(q, *args)),
            plain_ms=cuda_ms(lambda: ohchem.ohreaction_plain(q, g, *args),
                             3),
            mass_lost=lost, bitwise=True, max_abs_err=0.0)
    noh = len(g.lon) * len(g.lat) * len(g.alt_top)
    # bytes: positions, z, active, the mass in and out, one temperature
    # gather a particle; the two hourly fields and the axes once
    nbytes = n * (21 + 8 * 2 + 4) + 4 * (2 * noh + 125 + grid.nlev)
    # operations: the three scans (a subtraction, an absolute value and a
    # comparison per axis entry) and per species powf, two expf and six
    # other operations, each counted as one
    nops = n * (3 * (len(g.lon) + len(g.lat) + len(g.alt_top)) + 2 * 9)
    out = (ctypes.c_int * 3)()
    layout_fn = _build.OHREACTION.query("fp_ohreaction_layout",
                                        _build.OH_LAYOUT)
    err = layout_fn(len(g.lon), len(g.lat), len(g.alt_top), grid.nlev,
                    ctypes.addressof(out))
    check(err == 0, f"fp_ohreaction_layout: cudaError {err}")
    layout = dict(shared_bytes=out[0], blocks_per_sm=out[1],
                  registers=out[2])
    res.update(n=n, oh_grid=[len(g.lon), len(g.lat), len(g.alt_top)],
               ms=cases["cell_order"]["ms"],
               plain_ms=cases["cell_order"]["plain_ms"],
               unordered_ms=cases["as_drawn"]["ms"], max_abs_err=0.0,
               bitwise=True, library_ms=None, layout=layout,
               **bound(nbytes, nops), cases=cases)
    return res


def split_case(n: int, device, seed: int, live: float, due: float,
               future: float = 1.0 / 64):
    """n slots: a ``live`` share active (released over the last hour, two
    species), of which a ``due`` share is due to split at OH_ITIME; of the
    inactive slots a ``future`` share holds a release after it (never a
    child's slot), the rest free."""
    import torch
    from flexpart_tpu_torch.core.state import ITRA_INACTIVE, empty_particles
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo, hi, shape=(n,)):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    active = u(0.0, 1.0) < live
    fut = ~active & (u(0.0, 1.0) < future)
    itramem = u(OH_ITIME - 3600.0, OH_ITIME).to(torch.int32)
    itramem = torch.where(fut, OH_ITIME + 900, itramem)
    is_due = u(0.0, 1.0) < due
    split = torch.where(is_due, itramem + 600, torch.full_like(itramem,
                                                               10 ** 8))
    i32 = torch.int32
    return empty_particles(n, 2, device=device).replace(
        x_hi=u(0.0, 360.0), x_lo=u(-1e-6, 1e-6), y_hi=u(0.0, 180.0),
        y_lo=u(-1e-6, 1e-6), z=u(0.0, 3000.0),
        itra=torch.where(active | fut, torch.where(fut, itramem, OH_ITIME),
                         torch.full_like(itramem, ITRA_INACTIVE)),
        itramem=torch.where(active | fut, itramem, torch.zeros_like(itramem)),
        npoint=(u(0.0, 2.0)).to(i32), nclass=(u(0.0, 5.0)).to(i32),
        idt=(u(0.0, 900.0)).to(i32),
        itrasplit=torch.where(active | fut, split,
                              torch.full_like(split, ITRA_INACTIVE)),
        up=u(-1.0, 1.0), vp=u(-1.0, 1.0), wp=u(-0.1, 0.1),
        usig=u(0.0, 1.0), vsig=u(0.0, 1.0), wsig=u(0.0, 0.1),
        cbt=torch.where(u(0.0, 1.0) < 0.5, 1, -1).to(torch.int8),
        mass=u(0.5, 1.5, (n, 2)) / n, mass0=u(1.5, 2.0, (n, 2)) / n,
        xscav=u(0.0, 1.0, (n, 2)), active=active)


def clone_particles(p):
    from flexpart_tpu_torch.core.state import FIELDS, Particles
    return Particles(**{f: getattr(p, f).clone() for f in FIELDS})


SPLIT_CASES = (("due_25", 0.5, 0.25), ("due_75_guard", 0.75, 0.75),
               ("sorted_origin", 0.5, 0.25))
# the edge cases of K13 and K14: sizes around a warp, a 4096 tile and the
# origin bitmaps' 131,072-flag scan tile
EDGE_SIZES = (1, 31, 33, 4095, 4097, 2 ** 20 + 1)


def split_inputs(device, grid, n: int):
    """kernel_split's cases: (name, particles, origin or None)."""
    from flexpart_tpu_torch.core import reorder
    cfg = step_setup(grid)[0]
    zf = met_fields("synthetic", grid, device)[0]
    for name, live, due in SPLIT_CASES:
        p = split_case(n, device, 31, live, due)
        origin = None
        if name == "sorted_origin":
            p, perm = reorder.reorder_by_cell(p, zf.height, cfg)
            origin = perm.long()
        yield name, p, origin


def split_edge_inputs(device):
    """K13's edge cases at EDGE_SIZES: half live and half of them due, in
    slot order and through a shuffled origin; every slot live (no free
    slot); none due.  (name, particles, origin or None)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(37)
    for n in EDGE_SIZES:
        shuffled = torch.randperm(n, generator=gen, device=device)
        for name, live, due, origin in (
                ("identity", 0.5, 0.5, None),
                ("shuffled", 0.5, 0.5, shuffled),
                ("no_free", 1.0, 0.5, shuffled),
                ("none_due", 0.5, 0.0, None)):
            yield f"n{n}_{name}", split_case(n, device, n, live, due), origin


def held_split(p, origin, what: str, itime: int = OH_ITIME):
    """K13 and its plain version on copies of ``p``: every field and the
    counts bitwise, the counts those of the script's own masks.  Returns
    (the kernel's particles, the counts)."""
    from flexpart_tpu_torch.core import split as sp
    from flexpart_tpu_torch.core.state import FIELDS
    d, f = sp.due_and_free(p, itime, 1)
    want = [int(d.sum()), int(f.sum())]
    want.append(min(want))
    k, ck = sp.split_particles(clone_particles(p), itime, 1, origin)
    pl, cp = sp.split_particles_plain(clone_particles(p), itime, 1, origin)
    check(ck.tolist() == cp.tolist() == want,
          f"{what}: counts {ck.tolist()} / {cp.tolist()} / {want}")
    check_same_bits(k, pl, what, FIELDS)
    return k, want


def split_pairs(p, k):
    """The parents (slots whose split time doubled or mass halved) and
    the children (slots made live) of a split of ``p`` into ``k``."""
    import torch
    parents = p.active & ((k.itrasplit != p.itrasplit)
                          | (k.mass != p.mass).any(dim=1))
    children = k.active & ~p.active
    return (torch.nonzero(parents).flatten(),
            torch.nonzero(children).flatten())


def kernel_split(device, grid, n: int) -> dict:
    """K13 against its plain version on ``n`` slots (the capacity of the
    sim_oh_split phase): half of them free and a quarter of the live ones
    due (due_25); a quarter free and three quarters of the live ones due,
    which the free slots cannot all take (due_75_guard: the reference's
    maxpart guard); and due_25 after a cell-order sort, ranked through a
    shuffled origin (sorted_origin).  Every field and the counts bitwise;
    the granted count min(due, free) from masks of the script's own; the
    mass kept within rtol 1e-6 (float64 sums); every child in a free slot,
    every parent halved.  ``ms``: the device time of a call on a fresh
    copy (graph_on_copy_ms: CUDA graphs, the copies' own time taken out);
    ``profiled_ms`` and ``per_launch``: the same by the profiler, its
    kernels and memsets; ``ms_with_host``: CUDA events around the
    wrapper.  Bounds by bytes and
    by 32-byte sectors (k13_bounds).  Then the edge cases
    (split_edge_inputs), bitwise, untimed."""
    import torch
    from flexpart_tpu_torch.core import split as sp
    cases = {}
    for name, p, origin in split_inputs(device, grid, n):
        what = f"K13 {name}"
        d, f = sp.due_and_free(p, OH_ITIME, 1)
        m0 = p.mass[p.active].double().sum(0)
        k, want = held_split(p, origin, what)
        m1 = k.mass[k.active].double().sum(0)
        check(bool(torch.all((m1 - m0).abs() <= 1e-6 * m0)),
              f"{what}: mass {m0.tolist()} -> {m1.tolist()}")
        born = k.active & ~p.active
        check(int(born.sum()) == want[2] and bool(torch.all(f[born])),
              f"{what}: a child outside a free slot")
        halved = (k.mass != p.mass).any(dim=1) & p.active
        check(int(halved.sum()) == want[2], f"{what}: parents halved")
        parents, children = split_pairs(p, k)
        del k
        args = (OH_ITIME, 1, origin)
        free_o = torch.zeros(n, dtype=torch.bool, device=device)
        due_o = torch.zeros(n, dtype=torch.bool, device=device)
        o = origin if origin is not None else torch.arange(n, device=device)
        free_o[o] = f
        due_o[o] = d

        def scan_half():
            torch.cumsum(free_o, 0)
            torch.cumsum(due_o, 0)
        prof = profiled_in_place(lambda: clone_particles(p),
                                 lambda q: sp.split_particles(q, *args))
        cases[name] = dict(
            slots=n, due=want[0], free=want[1], granted=want[2],
            ms=graph_on_copy_ms(p, lambda q: sp.split_particles(q, *args)),
            profiled_ms=prof["device_ms"],
            ms_with_host=timed_in_place(
                lambda: clone_particles(p),
                lambda q: sp.split_particles(q, *args)),
            launches_per_call=prof["launches_per_call"],
            per_launch=prof["per_launch"],
            plain_ms=timed_in_place(
                lambda: clone_particles(p),
                lambda q: sp.split_particles_plain(q, *args), 3),
            library_ms=cuda_ms(scan_half), bitwise=True, max_abs_err=0.0,
            **k13_bounds(p, OH_ITIME, 1, origin is not None, parents,
                         children))
        del p, free_o, due_o
    t0 = time.perf_counter()
    edges = {}
    for name, p, origin in split_edge_inputs(device):
        edges[name] = held_split(p, origin, f"K13 edge {name}")[1]
    c = cases["sorted_origin"]
    return dict(n=n, **{f: c[f] for f in ("ms", "ms_with_host", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "bound_sectors_ms",
                                          "max_abs_err", "bitwise")},
                cases=cases, edge_cases_due_free_granted=edges,
                edge_cases_s=time.perf_counter() - t0)


# ------------------------------------------- domain fill, receptors, ... --

# the sim_domainfill phase's regional window (30 W - 45 E, 30 N - 75 N),
# its slots (the fill's 10 x 2**20 particles and room for the inflow), its
# output grids (1 degree over the window; the nest 0.25 degree over 10 W -
# 20 E, 40 N - 60 N) and its 32 receptors (8 x 4 points inside the window)
DF_BOX = dict(lon1=-30.0, lon2=45.0, lat1=30.0, lat2=75.0)
DF_CAPACITY = 11 * 2 ** 20
DF_SEED = 1234                 # Simulation's default seed
DF_HEIGHTS = (1000.0, 5000.0, 50000.0)
DF_OUTGRID = dict(outlon0=-30.0, outlat0=30.0, numxgrid=75, numygrid=45,
                  dxout=1.0, dyout=1.0, outheights=DF_HEIGHTS)
DF_NEST = dict(outlon0=-10.0, outlat0=40.0, numxgrid=120, numygrid=80,
               dxout=0.25, dyout=0.25, outheights=DF_HEIGHTS)
DF_RECEPTORS = tuple((f"R{8 * j + i:02d}", -26.0 + 9.0 * i, 35.0 + 10.0 * j)
                     for j in range(4) for i in range(8))
# K16 and K17 against the float64 sum of their pairs: a cell of m pairs
# within max(m * 2**-24, rtol), as K8 (float atomics, any order)
K16_RTOL = K8_RTOL
K17_RTOL = K8_RTOL
K14_OPS_PER_SITE = 40          # the flux, the accumulator and the count
K14_OPS_PER_WISH = 120         # a Philox call (about 100) and the position
K15_OPS_PER_PAIR = 15          # a particle at a receptor: 3 differences,
#                                3 quotients, the square sum and the kernel
K16_OPS_PER_PARTICLE = 60      # the cells of both positions and the faces
K17_OPS_PER_PARTICLE = 80      # the density's weights and gathers, the cell


def k17_bound(capacity: int, masked: int, nspec: int, cells_hit: int) -> dict:
    """K17's least time on one call: the mask of every slot, the masked
    particles' state and density read once, and each grid row (cell) that
    their pairs hit read and written once, nspec floats (however many
    pairs share it); the ops of K17_OPS_PER_PARTICLE for each masked
    particle."""
    return bound(capacity + masked * (24 + 4 * nspec + 32)
                 + cells_hit * 8 * nspec, masked * K17_OPS_PER_PARTICLE)

_FILL = {}


def df_window(grid) -> tuple:
    b = DF_BOX
    return ((b["lon1"] - grid.xlon0) / grid.dx,
            (b["lon2"] - grid.xlon0) / grid.dx,
            (b["lat1"] - grid.ylat0) / grid.dy,
            (b["lat2"] - grid.ylat0) / grid.dy)


def df_fill(grid, device):
    """The sim_domainfill phase's fill (init_domainfill on SyntheticMet's
    first field, the window, N_MAIN particles in DF_CAPACITY slots), made
    once in a run: (the particles as numpy arrays, the air mass, the
    boundary table as numpy arrays, seconds it took)."""
    if "fill" not in _FILL:
        from flexpart_tpu_torch.core import domainfill
        zf = met_fields("synthetic", grid, device)[0]
        t0 = time.perf_counter()
        parts, total, bnd = domainfill.init_domainfill(
            grid, zf, N_MAIN, 1, seed=DF_SEED, capacity=DF_CAPACITY,
            window=df_window(grid))
        _FILL["fill"] = (parts, total, bnd, time.perf_counter() - t0)
    return _FILL["fill"]


def filled_particles(grid, device, seed: int, move: float = 0.0):
    """The fill's particles on the card, all released at 0 and active, each
    moved by up to ``move`` grid units in x and y (some out of the
    window)."""
    import torch
    from flexpart_tpu_torch import interop
    parts = df_fill(grid, device)[0]
    p = interop.particles_from_numpy(parts, device)
    live = p.itra == 0
    if move:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        n = p.capacity
        p.x_hi += (torch.rand(n, generator=gen, device=device) * 2 - 1) * move
        p.y_hi += (torch.rand(n, generator=gen, device=device) * 2 - 1) * move
    return p.replace(active=live)


def held_against_f64(flats, lin, contrib, rtol_floor: float, what: str):
    """Scatter results ``flats`` {who: (rows, nspec) float32} against the
    float64 sum of the pairs (lin, contrib): a cell of m pairs within
    max(m * 2**-24, rtol_floor), relatively (check_depo_scatter's rule).
    Returns the errors and the pair counts."""
    import torch
    rows, nspec = next(iter(flats.values())).shape
    dev = lin.device
    ref = torch.zeros((rows, nspec), dtype=torch.float64, device=dev)
    ref.index_add_(0, lin, contrib.double())
    pairs = torch.zeros(rows, dtype=torch.int64, device=dev)
    pairs.index_add_(0, lin, torch.ones_like(lin))
    rtol = torch.clamp(pairs.double() * 2.0 ** -24, min=rtol_floor)[:, None]
    check(float(ref.sum()) > 0.0, f"{what}: nothing added")
    out = dict(pairs=int(lin.numel()), cells_hit=int((pairs != 0).sum()),
               most_pairs_in_a_cell=int(pairs.max()))
    for who, flat in flats.items():
        d = (flat.double() - ref).abs()
        rel = float((d / ref.clamp(min=1e-300)).max())
        check(bool(torch.all(d <= rtol * ref)),
              f"{what} {who}: a cell is further from the float64 sum of its "
              f"pairs than their count allows, max rel {rel}")
        out[f"{who}_max_rel_err_vs_f64"] = rel
        if who == "kernel":
            out["max_abs_err"] = float(d.max())
    return out


def boundcond_inputs(device, grid):
    """kernel_boundcond's step: (particles, their origin, the boundary
    state, the step's arguments of boundcond after the state, less
    mdomainfill and what follows it)."""
    import torch
    from flexpart_tpu_torch.core import domainfill as df
    from flexpart_tpu_torch.core import reorder, rng
    cfg = step_setup(grid)[0]
    z0, z1 = met_fields("synthetic_pv", grid, device, times=(0.0, 3600.0))
    bnd = df_fill(grid, device)[2]
    p, perm = reorder.reorder_by_cell(
        filled_particles(grid, device, 41, move=0.5), z0.height, cfg)
    bs = df.BoundaryState.from_numpy(bnd, device)
    xpp = bs.limits()[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(43)
    bs.acc = torch.rand(bs.sites, generator=gen, device=device) * 6.0 * xpp
    itime, mt0, mt1 = 900, 0, 3600
    w0, w1 = df.time_weights(itime, mt0, mt1)
    key = rng.Key(DF_SEED, 3000001)
    step = (z0.f3d, z1.f3d, z0.height, itime, w0, w1, key, LSYNC, 499999999,
            grid.ylat0, grid.dy)
    return p, perm.long(), bs, step


def held_boundcond(p, bs, step, md: int, origin, what: str):
    """K14 and its plain version on copies of ``p``: every field, the
    accumulator and the counts bitwise.  Returns (the kernel's particles,
    the counts)."""
    import torch
    from flexpart_tpu_torch.core import domainfill as df
    from flexpart_tpu_torch.core.state import FIELDS
    args = (bs, *step, md, 1, 1, True, origin)
    pk, pp = clone_particles(p), clone_particles(p)
    acc_k, ck = df.boundcond_cuda(pk, *args)
    acc_p, cp = df.boundcond_plain(pp, *args)
    check(ck.tolist() == cp.tolist(),
          f"{what}: counts {ck.tolist()} / {cp.tolist()}")
    check_same_bits(pk, pp, what, FIELDS)
    check(torch.equal(acc_k.view(torch.int32), acc_p.view(torch.int32)),
          f"{what}: the accumulators differ")
    return pk, ck.tolist()


def boundcond_edge_inputs(p, bs, window, device):
    """K14's edge cases at EDGE_SIZES, slots drawn from the kernels case's
    ``p`` (its boundary state ``bs``): in slot order and through a
    shuffled origin; every slot live and inside the window (no free slot);
    an empty accumulator (no wish); no boundary site at all, with half the
    slots live outside the window (the kill alone).  (name, particles,
    origin or None, boundary state)."""
    import torch
    from flexpart_tpu_torch.core.domainfill import BOUNDARY_FIELDS
    from flexpart_tpu_torch.core.state import FIELDS, Particles
    xlo, xhi, ylo, yhi = window
    x, y = p.x, p.y
    inside = (x >= xlo) & (x <= xhi) & (y >= ylo) & (y <= yhi)
    dry = bs.replace(acc=torch.zeros_like(bs.acc))
    no_site = bs.replace(**{f: getattr(bs, f)[:0]
                            for f in BOUNDARY_FIELDS[:15]})
    gen = torch.Generator(device=device)
    gen.manual_seed(47)
    pool = {"all": torch.arange(p.capacity, device=device),
            "inside": torch.nonzero(p.active & inside).flatten(),
            "outside": torch.nonzero(p.active & ~inside).flatten()}

    def pick(kind, n):
        src = pool[kind]
        return src[torch.randperm(src.numel(), generator=gen,
                                  device=device)[:n]]

    def take(kind, n):
        if kind == "half_outside":
            # the first half live outside the window (drawn again where
            # there are fewer), the rest from every slot
            out = pool["outside"]
            idx = torch.cat((out[torch.randint(out.numel(), ((n + 1) // 2,),
                                               generator=gen,
                                               device=device)],
                             pick("all", n // 2)))
        else:
            idx = pick(kind, n)
        return Particles(**{f: getattr(p, f)[idx].contiguous()
                            for f in FIELDS})

    for n in EDGE_SIZES:
        shuffled = torch.randperm(n, generator=gen, device=device)
        for name, kind, origin, b in (
                ("identity", "all", None, bs),
                ("shuffled", "all", shuffled, bs),
                ("no_free", "inside", shuffled, bs),
                ("no_wish", "all", None, dry),
                ("no_site", "half_outside", shuffled, no_site)):
            yield f"n{n}_{name}", take(kind, n), origin, b


def kernel_boundcond(device, grid) -> dict:
    """K14 against its plain version on the sim_domainfill phase's fill:
    11 x 2**20 slots, 10 x 2**20 of them filled and moved by up to half a
    cell (so that some leave the window), in cell order with their origin
    shuffled by the sort; the site table of the window with an accumulator
    of up to six particle masses a site (the four-round cap and its carry);
    a step between SyntheticMet's first two fields, with the port's Philox
    draws.  MDOMAINFILL 1 and 2: every particle field, the accumulator and
    the counts bitwise; some particles killed, some emitted.  ``ms``: the
    device time of a call on a fresh copy (graph_on_copy_ms);
    ``profiled_ms`` and ``per_launch``: the same by the profiler, its
    kernels and memsets; ``ms_with_host``: CUDA events around the
    wrapper.  Bounds by bytes and by 32-byte sectors (k14_bounds).  Its
    library call: torch.cumsum of the free flags in origin order (the
    ranking's scan half).  Then the edge cases (boundcond_edge_inputs),
    MDOMAINFILL 1, bitwise, untimed."""
    import torch
    from flexpart_tpu_torch.core import domainfill as df
    from flexpart_tpu_torch.core.state import ITRA_INACTIVE
    fill_s = df_fill(grid, device)[3]
    p, origin, bs, step = boundcond_inputs(device, grid)
    f3d = step[0]
    n, s = p.capacity, bs.sites
    _, xlo, xhi, ylo, yhi = bs.limits()
    x, y = p.x, p.y
    outside = (y < ylo) | (y > yhi) | (x < xlo) | (x > xhi)
    killed_idx = torch.nonzero(p.active & outside).flatten()
    cases = {}
    for md in (1, 2):
        what = f"K14 mdomainfill={md}"
        args = (bs, *step, md, 1, 1, True, origin)
        pk, counts = held_boundcond(p, bs, step, md, origin, what)
        killed, free, wanted, granted = counts
        check(killed > 0 and granted > 0 and granted == min(free, wanted)
              and killed == killed_idx.numel(),
              f"{what}: counts {counts}")
        born = pk.active & (pk.itramem == step[3])
        check(int(born.sum()) == granted, f"{what}: new particles")
        born_idx = torch.nonzero(born).flatten()
        del pk
        free_o = torch.zeros(n, dtype=torch.bool, device=device)
        free_o[origin] = (~p.active) & ((p.itra == ITRA_INACTIVE)
                                        | (p.itra != p.itramem))
        prof = profiled_in_place(lambda: clone_particles(p),
                                 lambda q: df.boundcond_cuda(q, *args))
        cases[f"mdomainfill_{md}"] = dict(
            slots=n, sites=s, killed=killed, free=free, wanted=wanted,
            granted=granted, bitwise=True, max_abs_err=0.0,
            ms=graph_on_copy_ms(p, lambda q: df.boundcond_cuda(q, *args)),
            profiled_ms=prof["device_ms"],
            ms_with_host=timed_in_place(
                lambda: clone_particles(p),
                lambda q: df.boundcond_cuda(q, *args)),
            launches_per_call=prof["launches_per_call"],
            per_launch=prof["per_launch"],
            plain_ms=timed_in_place(lambda: clone_particles(p),
                                    lambda q: df.boundcond_plain(q, *args),
                                    3),
            library_ms=cuda_ms(lambda: torch.cumsum(free_o, 0)),
            **k14_bounds(p, True, bs, f3d.shape[1],
                         f3d.shape[2] * f3d.shape[3], md, True, killed_idx,
                         born_idx))
        del free_o
    t0 = time.perf_counter()
    edges = {}
    for name, q, o, b in boundcond_edge_inputs(p, bs, (xlo, xhi, ylo, yhi),
                                               device):
        edges[name] = held_boundcond(q, b, step, 1, o,
                                     f"K14 edge {name}")[1]
        if name.endswith(("no_free", "no_wish", "no_site")):
            check(edges[name][3] == 0, f"K14 edge {name}: {edges[name]}")
        if name.endswith("no_site"):
            check(edges[name][0] >= (q.capacity + 1) // 2,
                  f"K14 edge {name}: {edges[name]}")
    c = cases["mdomainfill_1"]
    return dict(n=n, sites=s, fill_s=fill_s,
                **{f: c[f] for f in ("ms", "ms_with_host", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "bound_sectors_ms", "max_abs_err",
                                     "bitwise")}, cases=cases,
                edge_cases_killed_free_wanted_granted=edges,
                edge_cases_s=time.perf_counter() - t0)


def df_receptors(grid, device):
    from flexpart_tpu_torch.config import Receptor
    from flexpart_tpu_torch.grid import receptors
    return receptors.build_receptors(
        tuple(Receptor(*r) for r in DF_RECEPTORS), grid, device)[0]


# K15's and K16's edge cases: one slot, a warp less one, a warp and one
# more, a block of 2**20 slots and one more
K1516_EDGE_SIZES = (1, 31, 33, 2 ** 20 + 1)
K15_ITIME = 10800              # the kernels cases' sampling time


def take_slots(p, idx):
    """The particles of ``p`` at the slots ``idx``, contiguous."""
    from flexpart_tpu_torch.core.state import FIELDS, Particles
    return Particles(**{f: getattr(p, f)[idx].contiguous() for f in FIELDS})


def receptor_inputs(device, grid):
    """K15's cases at the 32 receptors of the sim_domainfill phase, each in
    cell order and every active particle sampled at K15_ITIME with an age
    of up to 3 h: the fill's 10 x 2**20 particles (``fill``: the domain's
    air through the whole column, so nearly every warp ends at the height
    gate); the same with every live particle's z drawn in 0-100 m
    (``surface``: every warp passes the gate and the horizontal tests
    decide); the fill with a tenth of the particles moved to within half a
    kernel width of a receptor at 0-100 m (``at_receptors``: the divisions
    and the shuffle trees).  Yields (name, particles)."""
    import torch
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.grid import receptors as rc
    cfg = step_setup(grid)[0]
    z0 = met_fields("synthetic", grid, device)[0]
    p, _ = reorder.reorder_by_cell(filled_particles(grid, device, 47),
                                   z0.height, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(53)
    n = p.capacity

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    p = p.replace(itra=torch.where(p.active, K15_ITIME, p.itra),
                  itramem=torch.where(p.active, (u(0.0, 1.0) * K15_ITIME).to(
                      torch.int32), p.itramem))
    yield "fill", p
    surface = p.replace(z=torch.where(p.active, u(0.0, 100.0), p.z))
    yield "surface", reorder.reorder_by_cell(surface, z0.height, cfg)[0]
    del surface
    rec = df_receptors(grid, device)
    r = rec.x.shape[0]
    hx, hy, _ = rc.kernel_widths(p, grid.dx, grid.dy)
    sel = p.active & (u(0.0, 1.0) < 0.1)
    j = torch.clamp((u(0.0, 1.0) * r).long(), max=r - 1)
    zero = torch.zeros_like(p.x_lo)
    moved = p.replace(
        x_hi=torch.where(sel, rec.x[j] + u(-0.5, 0.5) * hx, p.x_hi),
        x_lo=torch.where(sel, zero, p.x_lo),
        y_hi=torch.where(sel, rec.y[j] + u(-0.5, 0.5) * hy, p.y_hi),
        y_lo=torch.where(sel, zero, p.y_lo),
        z=torch.where(sel, u(0.0, 100.0), p.z))
    yield "at_receptors", reorder.reorder_by_cell(moved, z0.height, cfg)[0]


def on_kernel_boundary(q, rec, itime: int, dx: float, dy: float):
    """``q`` live at ``itime``, particle i at receptor i mod R, on or a
    float inside the edge of its kernel by i mod 4: 0, x the first float
    with x - rx at or beyond hx (y = ry, z = 0); 1, z = hz (x = rx, y =
    ry); 2, x the float below case 0's; 3, z the float below hz."""
    import torch
    from flexpart_tpu_torch.grid import receptors as rc
    n, dev = q.capacity, q.device
    q = q.replace(active=torch.ones_like(q.active),
                  itra=torch.full_like(q.itra, itime))
    hx, _, hz = rc.kernel_widths(q, dx, dy)
    i = torch.arange(n, device=dev)
    j = i % rec.x.shape[0]
    rx, ry = rec.x[j], rec.y[j]
    x0 = rx + hx
    x0 = torch.where(x0 - rx < hx, torch.nextafter(
        x0, torch.full_like(x0, float("inf"))), x0)
    kind = i % 4
    down = torch.full_like(x0, float("-inf"))
    x = torch.where(kind == 0, x0, torch.where(
        kind == 2, torch.nextafter(x0, down), rx))
    z = torch.where(kind == 1, hz, torch.where(
        kind == 3, torch.nextafter(hz, torch.zeros_like(hz)),
        torch.zeros_like(hz)))
    zero = torch.zeros_like(x)
    return q.replace(x_hi=x, x_lo=zero, y_hi=ry.clone(), y_lo=zero, z=z)


def receptor_edge_inputs(p, rec, itime: int, dx: float, dy: float,
                         device):
    """K15's edge cases at K1516_EDGE_SIZES, slots drawn from the fill
    case ``p``: as drawn; no live particle; every particle on the edge of
    its receptor's kernel or a float inside it (on_kernel_boundary).
    Yields (name, particles)."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(59)
    for n in K1516_EDGE_SIZES:
        idx = torch.randperm(p.capacity, generator=gen, device=device)[:n]
        q = take_slots(p, idx)
        yield f"n{n}_drawn", q
        yield f"n{n}_no_live", q.replace(active=torch.zeros_like(q.active))
        yield f"n{n}_boundary", on_kernel_boundary(q, rec, itime, dx, dy)


def held_receptors(c0, rec, p, itime: int, dx: float, dy: float,
                   what: str, cuda=None):
    """K15 (``cuda``: its wrapper, sample_receptors_cuda unless given) and
    its plain version on the same inputs, bitwise.  Returns the kernel's
    result."""
    import torch
    from flexpart_tpu_torch.grid import receptors as rc
    args = (c0, rec, p, itime, 1.0, dx, dy)
    k = (cuda or rc.sample_receptors_cuda)(*args)
    pl = rc.sample_receptors_plain(*args)
    check(torch.equal(k.view(torch.int32), pl.view(torch.int32)),
          f"{what}: kernel and plain differ by {float((k - pl).abs().max())}")
    return k


def k15_bounds(p, rec, itime: int, dx: float, dy: float) -> dict:
    """K15's least time on one call, by what the sampling needs: every
    slot's active and itra, a live one's z, its itramem where |z| < HZMAX
    (hz is at most HZMAX), a near one's (live, |z| < hz) x and y, hi and
    lo, the mass of a particle inside some receptor's kernel, and each
    block's partial of every (receptor, species) once; the operations of
    K15_OPS_PER_PAIR for each pair past the gate (may_be_inside), which
    must hold every pair inside.  ``bound_all_slots_ms``: the first K15's
    bound, every slot charged 29 + 4 nspec B."""
    import torch
    from flexpart_tpu_torch.grid import receptors as rc
    n, nspec, r = p.capacity, p.nspec, rec.x.shape[0]
    live = p.active & (p.itra == itime)
    hx, hy, hz = rc.kernel_widths(p, dx, dy)
    low = live & (p.z.abs() < rc.HZMAX)
    near = live & (p.z.abs() < hz)
    hit = torch.zeros_like(live)
    gated = inside = 0
    for j in range(r):
        gate = rc.may_be_inside(rec, p, itime, j, hx, hy, hz)
        ins = live & (rc.receptor_r2(rec, p, j, hx, hy, hz) < 1.0)
        check(not bool((ins & ~gate).any()),
              f"K15 gate: receptor {j} drops a pair inside")
        gated += int(gate.sum())
        inside += int(ins.sum())
        hit |= ins
    blocks = max(-(-n // rc.THREADS), 1)
    n_live = int(live.sum())
    nbytes = (5 * n + 4 * n_live + 4 * int(low.sum()) + 16 * int(near.sum())
              + 4 * nspec * int(hit.sum()) + 4 * r * nspec * blocks)
    return dict(**bound(nbytes, gated * K15_OPS_PER_PAIR),
                bound_all_slots_ms=bound(
                    n * (29 + 4 * nspec),
                    n_live * r * K15_OPS_PER_PAIR)["bound_ms"],
                live=n_live, near=int(near.sum()), pairs_past_gate=gated,
                pairs_inside=inside, particles_inside=int(hit.sum()))


def kernel_receptors(device, grid) -> dict:
    """K15 against its plain version, bitwise (both add in the same fixed
    order), on receptor_inputs' cases (fill, surface, at_receptors) at the
    32 receptors of the sim_domainfill phase; on the fill half the
    receptors at least see some mass, at_receptors all of them.  ``ms``
    (the fill case's, as every case's): device time, calls captured into a
    CUDA graph and replayed; ``ms_with_host``: CUDA events around the
    wrapper; ``per_launch``: the profiler's two launches.  Bounds by need
    (k15_bounds).  Its library call: torch.mm of the (R, N) kernel weights,
    made beforehand, by the mass (the product half of JAX's formulation),
    by graphs too.  Then the edge cases (receptor_edge_inputs), bitwise,
    untimed."""
    import torch
    from flexpart_tpu_torch.grid import receptors as rc
    rec = df_receptors(grid, device)
    r = rec.x.shape[0]
    itime, dx, dy = K15_ITIME, grid.dx, grid.dy
    cases = {}
    fill = None
    for name, p in receptor_inputs(device, grid):
        c0 = torch.zeros((r, p.nspec), dtype=torch.float32, device=device)
        args = (c0, rec, p, itime, 1.0, dx, dy)
        k = held_receptors(c0, rec, p, itime, dx, dy, f"K15 {name}")
        seen = int((k[:, 0] > 0).sum())
        check(seen >= (r // 2 if name == "fill" else
                       r if name == "at_receptors" else 0),
              f"K15 {name}: {r - seen} of {r} receptors see nothing")
        hx, hy, hz = rc.kernel_widths(p, dx, dy)
        w = torch.stack([rc.receptor_weights(rec, p, itime, j, hx, hy, hz)
                         for j in range(r)])
        library_ms = cuda_graph_ms(lambda: torch.mm(w, p.mass), 10)
        del w, hx, hy, hz
        prof = profiled_in_place(lambda: p,
                                 lambda q: rc.sample_receptors_cuda(
                                     c0, rec, q, itime, 1.0, dx, dy))
        cases[name] = dict(
            n=p.capacity, receptors_seeing_mass=seen, bitwise=True,
            max_abs_err=0.0,
            ms=cuda_graph_ms(lambda: rc.sample_receptors_cuda(*args)),
            ms_with_host=cuda_ms(lambda: rc.sample_receptors_cuda(*args)),
            profiled_ms=prof["device_ms"],
            launches_per_call=prof["launches_per_call"],
            per_launch=prof["per_launch"],
            plain_ms=cuda_ms(lambda: rc.sample_receptors_plain(*args), 2),
            library_ms=library_ms,
            **k15_bounds(p, rec, itime, dx, dy))
        if name == "fill":
            fill = p
        del p
    t0 = time.perf_counter()
    edges = {}
    for name, q in receptor_edge_inputs(fill, rec, itime, dx, dy, device):
        c0 = torch.zeros((r, q.nspec), dtype=torch.float32, device=device)
        k = held_receptors(c0, rec, q, itime, dx, dy, f"K15 edge {name}")
        if name.endswith("no_live"):
            check(not bool(k.any()), f"K15 edge {name}: {k}")
        edges[name] = float(k.sum())
    c = cases["fill"]
    return dict(receptors=r, **{f: c[f] for f in (
        "n", "receptors_seeing_mass", "pairs_inside", "ms", "ms_with_host",
        "per_launch", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_bytes", "bound_operations",
        "bound_all_slots_ms", "bitwise", "max_abs_err")}, cases=cases,
        edge_cases_sum=edges, edge_cases_s=time.perf_counter() - t0)


def df_flux_config(grid):
    from flexpart_tpu_torch.config import OutGrid
    from flexpart_tpu_torch.grid.fluxes import FluxConfig
    from flexpart_tpu_torch.grid.outgrid import OutputGridGeometry
    og = OutGrid(**DF_OUTGRID)
    geo = OutputGridGeometry(og, grid)
    return FluxConfig(nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg, npointspec=1,
                      nage=1, dxout=og.dxout, dyout=og.dyout,
                      xoutshift=geo.xoutshift, youtshift=geo.youtshift,
                      dx_met=grid.dx, dy_met=grid.dy, nx_met=grid.nx)


def flux_inputs(device, grid):
    """K16's case: the fill's 10 x 2**20 particles in cell order, each
    moved in the step by up to 1.5 cells in x, 1 in y and 300 m in z, on
    the sim_domainfill phase's 1-degree grid over the window.  Returns
    calcfluxes' arguments after the flux: (particles, xold, yold, zold,
    itime, lage, outheight, its half levels, config)."""
    import torch
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.grid import fluxes as fx
    cfg = step_setup(grid)[0]
    z0 = met_fields("synthetic", grid, device)[0]
    p, _ = reorder.reorder_by_cell(filled_particles(grid, device, 59),
                                   z0.height, cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(61)
    n = p.capacity

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    itime = 900
    xold, yold, zold = p.x, p.y, p.z.clone()
    p = p.replace(x_hi=p.x_hi + u(-1.5, 1.5), y_hi=p.y_hi + u(-1.0, 1.0),
                  z=torch.clamp(p.z + u(-300.0, 300.0), min=0.0),
                  itra=torch.where(p.active, itime, p.itra))
    lage = torch.tensor([999999999], dtype=torch.int32, device=device)
    oh = torch.tensor(DF_HEIGHTS, dtype=torch.float32, device=device)
    ohh = torch.as_tensor(fx.half_levels(DF_HEIGHTS), device=device)
    return (p, xold, yold, zold, itime, lage, oh, ohh, df_flux_config(grid))


def flux_edge_inputs(args, device):
    """K16's edge cases at K1516_EDGE_SIZES, slots drawn from its case
    (``args``: calcfluxes' arguments after the flux): as drawn; no live
    particle.  Yields (name, arguments)."""
    import torch
    p, xold, yold, zold = args[:4]
    gen = torch.Generator(device=device)
    gen.manual_seed(67)
    for n in K1516_EDGE_SIZES:
        idx = torch.randperm(p.capacity, generator=gen, device=device)[:n]
        q = take_slots(p, idx)
        old = tuple(v[idx].contiguous() for v in (xold, yold, zold))
        yield f"n{n}_drawn", (q, *old, *args[4:])
        yield f"n{n}_no_live", (q.replace(active=torch.zeros_like(q.active)),
                                *old, *args[4:])


def k16_bound(p, itime: int, per_release: bool, cells_hit: int) -> dict:
    """K16's least time on one call, by what the step needs: every slot's
    active and itra, a live one's x and y (hi and lo), z, the old x, y and
    z, itramem, npoint (where the flux is per release) and mass, and each
    flux row its crossings hit read and written once (8 nspec B), however
    many crossings share it (K17's rule); the operations of
    K16_OPS_PER_PARTICLE for each live particle."""
    n_live = int((p.active & (p.itra == itime)).sum())
    per_live = 36 + (4 if per_release else 0) + 4 * p.nspec
    return bound(5 * p.capacity + n_live * per_live
                 + cells_hit * 8 * p.nspec, n_live * K16_OPS_PER_PARTICLE)


def held_fluxes(args, what: str, ioutputforeachrelease: bool = True,
                cuda=None):
    """K16 (``cuda``: its wrapper, calcfluxes_cuda unless given) and its
    plain version on zero flux arrays, each against the float64 sum of the
    pairs (flux_pairs; K8's rule), or both all zero where there is no
    crossing.  Returns held_against_f64's numbers, the kernel's flux, the
    pairs and their contributions."""
    import torch
    from flexpart_tpu_torch.grid import fluxes as fx
    p, cfg = args[0], args[-1]
    fk = fx.zero_flux(cfg, p.nspec, p.device)
    fp = torch.zeros_like(fk)
    (cuda or fx.calcfluxes_cuda)(fk, *args, ioutputforeachrelease)
    fx.calcfluxes_plain(fp, *args, ioutputforeachrelease)
    idx, valid = fx.flux_pairs(*args, ioutputforeachrelease)
    lin = idx[valid]
    contrib = p.mass[torch.nonzero(valid, as_tuple=True)[0]]
    del idx, valid
    if lin.numel() == 0:
        check(not bool(fk.any()) and not bool(fp.any()),
              f"{what}: a crossing added where there is none")
        res = dict(pairs=0, cells_hit=0, most_pairs_in_a_cell=0,
                   max_abs_err=0.0)
    else:
        res = held_against_f64({"kernel": fk.view(-1, p.nspec),
                                "plain": fp.view(-1, p.nspec)}, lin,
                               contrib, K16_RTOL, what)
    del fp
    return res, fk, lin, contrib


def kernel_fluxes(device, grid) -> dict:
    """K16 against the float64 sum of its pairs (and its plain version, to
    the same rule) on flux_inputs' case.  ``ms``: device time, calls (which
    add into one flux array) captured into a CUDA graph and replayed;
    ``ms_with_host``: CUDA events around the wrapper; ``per_launch``: by
    the profiler.  Its bound by need (k16_bound: each flux row once) and
    the first K16's (8 nspec B a crossing) beside it.  Its library call:
    index_add_ of its pairs (the scatter half), by graphs too.  Then the
    edge cases (flux_edge_inputs), untimed."""
    import torch
    from flexpart_tpu_torch.grid import fluxes as fx
    args = flux_inputs(device, grid)
    p, itime, fcfg = args[0], args[4], args[-1]
    res, fk, lin, contrib = held_fluxes(args, "K16")
    flat_l = torch.zeros_like(fk).view(-1, p.nspec)
    res["library_ms"] = cuda_graph_ms(
        lambda: flat_l.index_add_(0, lin, contrib), 10)
    res["faces"] = {f: float(fk[i].sum()) for i, f in enumerate(
        ("east", "west", "north", "south", "up", "down"))}
    check(all(v > 0 for v in res["faces"].values()),
          f"K16: a face direction is never crossed {res['faces']}")
    nspec, n = p.nspec, p.capacity
    del flat_l, lin, contrib
    prof = profiled_in_place(lambda: fk,
                             lambda f: fx.calcfluxes_cuda(f, *args))
    res.update(n=n, grid=[6, 1, 1, fcfg.nzg, fcfg.nyg, fcfg.nxg, nspec],
               ms=cuda_graph_ms(lambda: fx.calcfluxes_cuda(fk, *args)),
               ms_with_host=cuda_ms(lambda: fx.calcfluxes_cuda(fk, *args)),
               profiled_ms=prof["device_ms"],
               launches_per_call=prof["launches_per_call"],
               per_launch=prof["per_launch"],
               plain_ms=cuda_ms(lambda: fx.calcfluxes_plain(
                   torch.zeros_like(fk), *args), 3),
               bound_per_crossing_ms=bound(
                   n * (45 + 4 * nspec) + res["pairs"] * 8 * nspec,
                   n * K16_OPS_PER_PARTICLE)["bound_ms"],
               **k16_bound(p, itime, True, res["cells_hit"]))
    del fk
    t0 = time.perf_counter()
    edges = {}
    for name, a in flux_edge_inputs(args, device):
        r, _, _, _ = held_fluxes(a, f"K16 edge {name}")
        if name.endswith("no_live"):
            check(r["pairs"] == 0, f"K16 edge {name}: {r}")
        edges[name] = r["pairs"]
    res.update(edge_cases_pairs=edges, edge_cases_s=time.perf_counter() - t0)
    return res


# K17's plume case: a tenth of the particles moved into a box of 3 x 1.5
# degrees at 0-3 km, whose pairs hit 120 cells of the 0.5-degree grid's
# three layers (the 4-point kernel reaches the box's neighbours), as
# sim_initcond's retroplume at its end hits 84
K17_PLUME_BOX = dict(lon=(28.0, 31.0), lat=(50.0, 51.5), z=(0.0, 3000.0))


def initcond_plume(p, device, seed: int, grid):
    """p with a tenth of its active particles (from a seed) moved into
    K17_PLUME_BOX, and that tenth's mask."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n = p.capacity

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    b = K17_PLUME_BOX
    sel = p.active & (u(0.0, 1.0) < 0.1)
    x = u(*((v - grid.xlon0) / grid.dx for v in b["lon"]))
    y = u(*((v - grid.ylat0) / grid.dy for v in b["lat"]))
    q = p.replace(x_hi=torch.where(sel, x, p.x_hi),
                  y_hi=torch.where(sel, y, p.y_hi),
                  z=torch.where(sel, u(*b["z"]), p.z))
    return q, sel


def kernel_initcond(device, grid) -> dict:
    """K17 against the float64 sum of its pairs (and its plain version, to
    the same rule) on the deposition particles (10 x 2**20 over the globe,
    two species), linit_cond = 1 (the density at each particle), on the
    sim_initcond phase's 720 x 360 x 3 grid: a step's terminated particles
    (a tenth, ``died``), the survivors at the run's end (every active one,
    ``run_end``) and a tenth moved into a plume of 120 cells
    (initcond_plume, ``plume``), each in cell order.  Its library call:
    index_add_ of its pairs."""
    import torch
    from flexpart_tpu_torch.core import reorder
    from flexpart_tpu_torch.grid import initcond as ic
    cfg, _, og, geo, _ = step_setup(grid)
    zf = met_fields("synthetic", grid, device)[0]
    spread = depo_particles(N_MAIN, device, 67, grid)
    p, _ = reorder.reorder_by_cell(spread, zf.height, cfg)
    plume, in_plume = initcond_plume(spread, device, 73, grid)
    plume, perm = reorder.reorder_by_cell(plume, zf.height, cfg)
    in_plume = in_plume[perm.long()]
    del spread
    icfg = ic.InitCondConfig(
        nxg=geo.nxg, nyg=geo.nyg, nzg=geo.nzg, npointspec=1,
        dxout=og.dxout, dyout=og.dyout, xoutshift=geo.xoutshift,
        youtshift=geo.youtshift, dx_met=grid.dx, dy_met=grid.dy,
        linit_cond=1)
    oh = torch.tensor(og.outheights, dtype=torch.float32, device=zf.height.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(71)
    n = p.capacity
    died = p.active & (torch.rand(n, generator=gen, device=device) < 0.1)
    cases = {}
    for name, q, mask in (("died", p, died), ("run_end", p, p.active),
                          ("plume", plume, in_plume)):
        p = q
        gk = ic.zero_init_cond(icfg, p.nspec, device)
        gp = torch.zeros_like(gk)
        ic.initcond_cuda(gk, p, mask, zf, oh, icfg)
        ic.initcond_plain(gp, p, mask, zf, oh, icfg)
        lin, valid, contrib = ic.initcond_pairs(p, mask, zf, oh, icfg)
        lin, contrib = lin[valid], contrib[valid]
        res = held_against_f64({"kernel": gk.view(-1, p.nspec),
                                "plain": gp.view(-1, p.nspec)}, lin, contrib,
                               K17_RTOL, f"K17 {name}")
        flat_l = torch.zeros_like(gk).view(-1, p.nspec)
        res["library_ms"] = cuda_ms(lambda: flat_l.index_add_(0, lin,
                                                               contrib), 3)
        m = int(mask.sum())
        del flat_l, lin, contrib, valid
        res.update(masked=m,
                   ms=cuda_ms(lambda: ic.initcond_cuda(gk, p, mask, zf, oh,
                                                      icfg)),
                   plain_ms=cuda_ms(lambda: ic.initcond_plain(
                       gp, p, mask, zf, oh, icfg), 3),
                   **k17_bound(n, m, p.nspec, res["cells_hit"]))
        cases[name] = res
    c = cases["died"]
    check(cases["plume"]["cells_hit"] < 200,
          f"K17 plume: {cases['plume']['cells_hit']} cells")
    return dict(n=n, **{f: c[f] for f in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err")}, cases=cases)

SIM_BACKWARD_DIR = ROOT / "build" / "sim_backward_smoke"
SIM_BKDEP_DIR = ROOT / "build" / "sim_bkdep_smoke"
# the kernels of a backward run's path: K7 takes its BACKWARD
# instantiation, and no deposit is gridded (no K8)
BACKWARD_PATH_KERNELS = ("advance", "quad_tables", "conccalc", "reorder",
                         "convection", "redist.backward", "wetdepo",
                         "drydepo")
N_BKDEP = 2 ** 20
BKDEP_STEPS = 4


def sim_backward_setup(outdir, device, write_netcdf: bool, n: int = N_MAIN,
                       hours: int = SIM_HOURS, ind_receptor: int = 1,
                       release_hours: int = 1, lout: int = 3600,
                       cmd_kw=None, **kw):
    """The port's Simulation of a backward run (``ldirect=-1``) at full
    width: ``n`` = 10 x 2**20 particles released over the last
    ``release_hours`` of the run (0: all at its end, the receptor time)
    from a 2 x 2 degree receptor box at 50-500 m in SyntheticMet's storm
    band (STORM_BOX, where its clouds rain), the sim phase's two species
    (one unit of mass each; the aerosol is scavenged wet and dry, and
    decays), ``hours`` of 900 s steps back from the run's end on the sim
    phase's grid (convection, subgrid orography and the polar caps on),
    output every ``lout`` seconds (hourly) on the 720x360x3 grid.
    ``ind_receptor`` 3 and 4 are the backward deposition modes (WETBKDEP,
    DRYBKDEP); ``cmd_kw`` more of the Command's options."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox,
                                           Releases)
    grid = make_grid(**SIM_GRID)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=hours * 10000, ldirect=-1, lsynctime=LSYNC,
                  loutstep=lout, loutaver=lout, loutsample=900,
                  ind_receptor=ind_receptor, **(cmd_kw or {}))
    box = ReleaseBox(idate1=20200101, itime1=(hours - release_hours) * 10000,
                     idate2=20200101, itime2=hours * 10000, z1=50.0,
                     z2=500.0, mass=(1.0, 1.0), parts=n, **STORM_BOX)
    og = OutGrid(outlon0=-180.0, outlat0=-90.0, numxgrid=720, numygrid=360,
                 dxout=0.5, dyout=0.5, outheights=(100.0, 1000.0, 50000.0))
    return Simulation(cmd=cmd, releases=Releases(species=sim_species(),
                                                 boxes=(box,)),
                      grid=grid, met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), device=device,
                      write_netcdf=write_netcdf, **kw)


def sim_backward_run_checks(sim, what: str, released: float) -> tuple:
    """What a backward run holds after its end: particle steps were made
    and the met reader never failed; every released particle active and
    finite; the last file's residence times finite, not negative, positive
    somewhere for each species; no deposit gridded; the tracer keeps its
    mass (``released``), the aerosol has lost some to K9 and K10 and kept
    most.  Returns (the numbers, the last file's name, its conc)."""
    import numpy as np
    import torch
    check(sim.timings["particle_steps"] > 0 and sim._prefetch_failures == 0,
          f"{what}: no particle steps, or the met reader failed")
    pa = sim.particles
    n = pa.capacity
    check(int(pa.active.sum()) == n, f"{what}: {int(pa.active.sum())} of "
          f"{n} active")
    for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "up", "vp", "wp", "mass"):
        check(bool(torch.isfinite(getattr(pa, f)).all()),
              f"{what}: {f} not finite")
    out = Path(sim.outdir)
    npz = sorted(q.name for q in out.glob("grid_conc_*.npz"))
    check(len(npz) >= 1, f"{what}: npz {npz}")
    conc = np.load(out / npz[-1])["conc"]
    check(bool(np.isfinite(conc).all()) and float(conc.min()) >= 0.0,
          f"{what}: conc not finite or negative")
    peaks = [float(conc[s].max()) for s in range(conc.shape[0])]
    for k, g in (("wet", sim.acc.wetgridunc), ("dry", sim.acc.drygridunc)):
        check(float(g.abs().sum()) == 0.0, f"{what}: a {k} deposit gridded")
    mass = [float(pa.mass[:, s].sum(dtype=torch.float64))
            for s in range(pa.nspec)]
    return dict(conc_max_per_species=peaks, airborne_mass=mass), \
        npz[-1], conc


def phase_sim_backward(device, kernels) -> dict:
    """A backward ``Simulation.run`` on the card at full width
    (sim_backward_setup), twice with one seed (run_twice, with
    sim_backward_run_checks): every kernel of the backward path launched
    (K7's BACKWARD instantiation, never the forward one; no deposit
    scatter), the two runs bitwise equal, the files a backward run writes
    (``grid_time_`` netCDF in seconds, the npz stem the reference keeps),
    positive residence times; the tracer's mass kept, the aerosol's
    depleted by the wet and the dry pass.  Run B's probe keeps one release
    step and one steady step (kept_steps), and on each the path's kernels
    are held against their plain versions (sim_backward_kernel_checks):
    the receptor's plume misses SyntheticMet's convecting columns, so K7
    BACKWARD is held there on those particles put in them too, where it
    must move some."""
    import shutil
    import numpy as np
    import torch
    try:
        import h5py  # noqa: F401
        netcdf = True
    except ImportError:
        netcdf = False
    shutil.rmtree(SIM_BACKWARD_DIR, ignore_errors=True)
    nsteps = SIM_HOURS * 3600 // LSYNC
    keep, snaps = {}, {}

    def setup(run):
        sim = sim_backward_setup(SIM_BACKWARD_DIR / run, device,
                                 netcdf and run == "a", profile=run == "b")
        keep.update(kept_steps(sim, nsteps, "sim_backward"))
        return sim

    def probe_fn(sim):
        def probe(istep, itime):
            if istep in keep:
                z0, z1, mt0, mt1 = sim._fields_for(itime)
                snaps[keep[istep]] = (istep, itime, sim.particles, z0, z1,
                                      mt0, mt1, sim._get_eta(mt0),
                                      sim._get_eta(mt1), sim.cbmf)
        return probe

    def check_a(sim):
        check(sim.cmd.ldirect == -1 and sim.step_cfg.ldirect == -1
              and sim.step_cfg.polar and sim.conv_kernel is not None
              and sim.bkdep == 0, "sim_backward: not a backward run's path")
        check(sorted(sim._release_times) == [-2700, -1800, -900, 0],
              f"sim_backward: release times {sorted(sim._release_times)}")
        out = Path(sim.outdir)
        dates = (out / "dates").read_text().split()
        check(dates == ["20200101013000", "20200101003000"],
              f"sim_backward: dates {dates}")
        npz = sorted(q.name for q in out.glob("grid_conc_*.npz"))
        check(npz == sorted(f"grid_conc_{d}.npz" for d in dates),
              f"sim_backward: npz {npz}")
        nc = sorted(q.name for q in out.glob("grid_*.nc"))
        check(nc == (["grid_time_20200101030000.nc"] if netcdf else []),
              f"sim_backward: nc {nc}")
        check(sim.writer.nc_meta["units"] == "s",
              f"sim_backward: units {sim.writer.nc_meta['units']}")
        first = np.load(out / npz[0])
        check(first["conc"].shape == (2, 1, 1, 3, 360, 720),
              f"sim_backward: conc {first['conc'].shape}")
        # the deposition grids, written as the reference writes them, stay 0
        check(not first["wet"].any() and not first["dry"].any(),
              "sim_backward: the npz carry deposits")
        return dict(dates=dates, units=sim.writer.nc_meta["units"])

    sim, rows, a = run_twice(setup, kernels, "sim_backward", 1.0,
                             BACKWARD_PATH_KERNELS, check_a, probe_fn,
                             run_checks=sim_backward_run_checks)
    launches = a["launches"]
    check(launches["advance"] == launches["quad_tables"] == nsteps
          and launches["wetdepo"] == launches["drydepo"] == nsteps
          and launches["convection"] == launches["redist.backward"]
          == nsteps + 1 and launches["redist"] == 0
          and launches["depo_scatter"] == 0
          and launches["conccalc.bkdep"] == 0,
          f"sim_backward: {launches} launches in {nsteps} steps")
    tracer, aerosol = a["airborne_mass"]
    check(abs(tracer - 1.0) < 1e-3, f"sim_backward: tracer mass {tracer}")
    check(0.5 < aerosol < 1.0 - 1e-6,
          f"sim_backward: aerosol mass {aerosol} not depleted")
    check(set(snaps) == set(keep.values()),
          f"sim_backward: kept steps {list(snaps)}")
    on_inputs = {name.replace(" ", "_"): sim_backward_kernel_checks(
        sim, snap, f"sim_backward {name} {snap[0]}")
        for name, snap in snaps.items()}
    snaps.clear()
    device_ms, per_launch = per_launch_of(rows)
    res = dict(
        n=N_MAIN, steps=nsteps, netcdf=netcdf, **a,
        kernels_on_sim_backward_inputs=on_inputs,
        device_ms_all_kernels=device_ms,
        device_per_call={
            "advance": per_launch(("advance_kernel",), nsteps),
            "quad_tables": per_launch(("quad_tables_kernel",), nsteps),
            "conccalc": per_launch(("conccalc_kernel",),
                                   launches["conccalc"]),
            "reorder": per_launch(SORT_KERNELS, a["sorts"]),
            "convection": per_launch(("convection_kernel",), nsteps + 1),
            "redist_backward": per_launch(("redist_kernel",), nsteps + 1),
            "wetdepo": per_launch(("wetdepo_kernel",), nsteps),
            "drydepo": per_launch(("drydepo_kernel",), nsteps)},
        top=[dict(name=k[:60], calls=c, ms=ms) for k, c, ms in rows[:10]])
    del sim
    shutil.rmtree(SIM_BACKWARD_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


SIM_DF_DIR = ROOT / "build" / "sim_domainfill_smoke"
SIM_IC_DIR = ROOT / "build" / "sim_initcond_smoke"
# the kernels of sim_domainfill's path: the stock step (no deposition: the
# tracer of a domain fill is air), the nest's sampling, the boundary (K14),
# the receptors (K15) and the fluxes (K16)
DF_PATH_KERNELS = ("advance", "quad_tables", "conccalc", "conccalc.nest",
                   "reorder", "convection", "redist", "domainfill",
                   "receptors", "fluxes")
IC_PATH_KERNELS = BACKWARD_PATH_KERNELS + ("initcond",)


def sim_domainfill_setup(outdir, device, write_netcdf: bool, **kw):
    """The port's Simulation of a regional domain fill at full width:
    MDOMAINFILL=1 over DF_BOX (30 W - 45 E, 30 N - 75 N) with N_MAIN
    particles in DF_CAPACITY slots (room for the inflow), the default
    Command (convection, subgrid orography) over SIM_HOURS hours of 900 s
    steps on the sim phase's grid, hourly output on the 1-degree grid over
    the window, iflux = 1, an OUTGRID_NEST at 0.25 degrees over 10 W - 20 E,
    40 N - 60 N and the 32 receptors of DF_RECEPTORS."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch.config import (Command, OutGrid, Receptor,
                                           ReleaseBox, Releases, Species)
    grid = make_grid(**SIM_GRID)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101,
                  ietime=SIM_HOURS * 10000, lsynctime=LSYNC, loutstep=3600,
                  loutaver=3600, loutsample=900, iflux=1, mdomainfill=1)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                     z1=0.0, z2=50000.0, mass=(1.0,), parts=N_MAIN, **DF_BOX)
    return Simulation(
        cmd=cmd, releases=Releases(species=(Species(),), boxes=(box,)),
        grid=grid, met_backend=SyntheticMet(grid),
        outgrid=OutGrid(**DF_OUTGRID), outdir=str(outdir), device=device,
        capacity=DF_CAPACITY, outgrid_nest=OutGrid(**DF_NEST),
        receptors=tuple(Receptor(*r) for r in DF_RECEPTORS),
        write_netcdf=write_netcdf, **kw)


def sim_domainfill_run_checks(sim, what: str, released: float) -> tuple:
    """What a regional domain fill holds after its run: particle steps made
    and the met reader never failed; the filled air mass (the fill's
    particles, before the first step) equal to airmass_total within 1e-3
    (the fill's rounding of particles per column), every live particle
    finite and inside the window; particles killed at the window's edge
    and emitted at its faces; the receptor, flux and nest files of every
    output, read back with the port's readers, finite and not negative,
    each with mass somewhere.  Returns (the numbers, the last file's name,
    its conc)."""
    import numpy as np
    import torch
    from flexpart_tpu_torch.io.fortran_writer import read_flux, read_receptor
    check(sim.timings["particle_steps"] > 0 and sim._prefetch_failures == 0,
          f"{what}: no particle steps, or the met reader failed")
    filled = sim._filled_mass
    check(abs(filled - sim.airmass_total) <= 1e-3 * sim.airmass_total,
          f"{what}: filled {filled} kg of {sim.airmass_total}")
    pa = sim.particles
    act = pa.active
    for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "up", "vp", "wp"):
        check(bool(torch.isfinite(getattr(pa, f)[act]).all()),
              f"{what}: {f} not finite")
    _, xlo, xhi, ylo, yhi = sim._boundary.limits()
    x, y = pa.x[act], pa.y[act]
    check(bool(((x >= xlo) & (x <= xhi) & (y >= ylo) & (y <= yhi)).all()),
          f"{what}: a live particle outside the window")
    counts = torch.stack(sim.boundary_counts).sum(0).tolist()
    killed, _, wanted, granted = counts
    check(killed > 0 and granted > 0 and granted == wanted,
          f"{what}: boundary (killed, free, wanted, granted) {counts}")
    out = Path(sim.outdir)
    npz = sorted(q.name for q in out.glob("grid_conc_*.npz"))
    dates = [n[len("grid_conc_"):-4] for n in npz]
    check(len(npz) == SIM_HOURS - 1, f"{what}: npz {npz}")
    names, _, _, steps = read_receptor(out / "receptor_conc", 1)
    check(len(names) == len(DF_RECEPTORS) and len(steps) == len(npz)
          and all(np.isfinite(v).all() and (v >= 0).all() for _, v in steps)
          and max(float(v.max()) for _, v in steps) > 0,
          f"{what}: receptor_conc")
    shape = np.load(out / f"grid_flux_{dates[-1]}.npz")["flux"].shape
    faces = []
    for d in dates:
        _, fl = read_flux(out / f"grid_flux_{d}", shape)
        check(bool(np.isfinite(fl).all() and (fl >= 0).all()),
              f"{what}: grid_flux_{d}")
        faces.append(fl.sum(axis=tuple(range(1, fl.ndim))).tolist())
        nest = np.load(out / "nest" / f"grid_conc_{d}.npz")["conc"]
        check(bool(np.isfinite(nest).all()) and float(nest.max()) > 0,
              f"{what}: nest grid_conc_{d}")
    check(all(v > 0 for v in faces[-1]), f"{what}: fluxes per face {faces}")
    conc = np.load(out / npz[-1])["conc"]
    check(bool(np.isfinite(conc).all()) and float(conc.max()) > 0,
          f"{what}: conc")
    return dict(airmass_total=sim.airmass_total, filled_mass=filled,
                fill_s=sim._fill_s, active=int(act.sum()),
                boundary_killed_free_wanted_granted=counts,
                sites=sim._boundary.sites,
                receptor_max=max(float(v.max()) for _, v in steps),
                flux_ng_m2_s_per_face_and_output=faces), npz[-1], conc


def phase_sim_domainfill(device, kernels) -> dict:
    """A regional domain fill through ``Simulation.run`` at full width
    (sim_domainfill_setup), twice with one seed (run_twice, with
    sim_domainfill_run_checks): every kernel of the path launched, K14 once
    a step, K15 and the nest's K3 at every sampling, K16 once a step; the
    two runs bitwise equal.  Run A fills the domain itself (the fill timed
    apart); run B starts from a copy of A's fill."""
    import shutil
    import torch
    from flexpart_tpu_torch.core import domainfill as df
    from flexpart_tpu_torch.grid import fluxes as fx
    from flexpart_tpu_torch.grid import receptors as rc
    try:
        import h5py  # noqa: F401
        netcdf = True
    except ImportError:
        netcdf = False
    shutil.rmtree(SIM_DF_DIR, ignore_errors=True)
    nsteps = SIM_HOURS * 3600 // LSYNC
    fill = {}

    def setup(run):
        sim = sim_domainfill_setup(SIM_DF_DIR / run, device,
                                   netcdf and run == "a", profile=run == "b")
        own_fill = sim._fill_domain

        def fill_and_keep():
            t0 = time.perf_counter()
            if run == "a":
                own_fill()
                fill.update(particles=clone_particles(sim.particles),
                            boundary=sim._boundary.to_numpy(),
                            total=sim.airmass_total)
            else:
                sim.particles = clone_particles(fill["particles"])
                sim._boundary = df.BoundaryState.from_numpy(
                    fill["boundary"], device)
                sim.airmass_total = fill["total"]
            sim._fill_s = time.perf_counter() - t0
            sim._filled_mass = float(
                sim.particles.mass.sum(dtype=torch.float64))
        sim._fill_domain = fill_and_keep
        return sim

    sim, rows, a = run_twice(setup, kernels, "sim_domainfill", 0.0,
                             DF_PATH_KERNELS,
                             run_checks=sim_domainfill_run_checks)
    launches = a["launches"]
    # the mother grid samples once more after each output (the next
    # window's first sample, flexpart_tpu/run/simulation.py:1248-1253), the
    # nest and the receptors not, as in the JAX package
    samplings = launches["conccalc"] - (SIM_HOURS - 1)
    check(launches["domainfill"] == nsteps + 1
          and launches["fluxes"] == nsteps
          and launches["receptors"] == launches["conccalc.nest"] == samplings
          and launches["advance"] == nsteps,
          f"sim_domainfill: {launches} launches in {nsteps} steps")
    device_ms, per_launch = per_launch_of(rows)
    calls = [c.tolist() for c in sim.boundary_counts]
    # K14's, K15's and K16's least time per call (boundcond_call_bounds:
    # the slots each call needs, its killed and new particles; k15_bounds;
    # k16_bound: each flux row a call's crossings hit), counted in a third
    # run, neither timed nor profiled and bitwise run B; K15 and K16 held
    # there against their plain versions on every call's inputs (K15
    # bitwise, K16 by K8's rule), each on copies of what it adds into
    bounds, inner = [], df.boundcond_cuda
    rc_inner, fx_inner = rc.sample_receptors_cuda, fx.calcfluxes_cuda
    held = {"receptors": [], "fluxes": []}

    def counting(p, *args):
        before = clone_particles(p)
        out = inner(p, *args)
        bounds.append(boundcond_call_bounds(before, p, args))
        del before
        return out

    def held_sampling(creceptor, rec, p, itime, weight, dx, dy):
        what = f"sim_domainfill K15 call {len(held['receptors'])}"
        held_receptors(torch.zeros_like(creceptor), rec, p, itime, dx, dy,
                       what, rc_inner)
        b = k15_bounds(p, rec, itime, dx, dy)
        held["receptors"].append({f: b[f] for f in (
            "bound_ms", "bound_by", "bound_all_slots_ms", "live", "near",
            "pairs_past_gate", "pairs_inside")})
        return rc_inner(creceptor, rec, p, itime, weight, dx, dy)

    def held_fluxes_call(flux, p, *args):
        what = f"sim_domainfill K16 call {len(held['fluxes'])}"
        per_release = args[-1] if len(args) > 8 else True
        r = held_fluxes((p, *args[:8]), what, per_release, fx_inner)[0]
        held["fluxes"].append(dict(
            **{f: r[f] for f in ("pairs", "cells_hit", "max_abs_err")},
            **{f: v for f, v in k16_bound(p, args[3], per_release,
                                          r["cells_hit"]).items()
               if f in ("bound_ms", "bound_by")}))
        return fx_inner(flux, p, *args)

    sim_c = setup("c")
    df.boundcond_cuda = counting
    rc.sample_receptors_cuda = held_sampling
    fx.calcfluxes_cuda = held_fluxes_call
    try:
        sim_c.run()
    finally:
        df.boundcond_cuda = inner
        rc.sample_receptors_cuda = rc_inner
        fx.calcfluxes_cuda = fx_inner
    check_same_bits(sim.particles, sim_c.particles,
                    "sim_domainfill: the counting run and run B")
    check(len(bounds) == nsteps + 1
          and [c.tolist() for c in sim_c.boundary_counts] == calls,
          f"sim_domainfill: {len(bounds)} calls counted")
    check(len(held["receptors"]) == samplings
          and len(held["fluxes"]) == nsteps,
          f"sim_domainfill: K15 and K16 held on "
          f"{len(held['receptors'])} and {len(held['fluxes'])} calls")
    del sim_c
    res = dict(
        n=N_MAIN, capacity=DF_CAPACITY, steps=nsteps, netcdf=netcdf, **a,
        device_ms_all_kernels=device_ms,
        domainfill_bound_ms_per_call=sum(b["bound_ms"] for b in bounds)
        / len(bounds),
        domainfill_bound_sectors_ms_per_call=sum(
            b["bound_sectors_ms"] for b in bounds) / len(bounds),
        domainfill_killed_free_wanted_granted_per_call=calls,
        receptors_held=held["receptors"], fluxes_held=held["fluxes"],
        receptors_bound_ms_per_call=sum(
            b["bound_ms"] for b in held["receptors"]) / samplings,
        fluxes_bound_ms_per_call=sum(
            b["bound_ms"] for b in held["fluxes"]) / nsteps,
        device_per_call={
            "advance": per_launch(("advance_kernel",), nsteps),
            "domainfill": per_launch(("boundary_",), nsteps + 1),
            # K14's memset of its bitmaps (no other kernel of the path
            # calls cudaMemsetAsync)
            "domainfill_memsets": per_launch(("Memset",), nsteps + 1),
            "receptors": per_launch(("receptor_",), samplings),
            "receptors_partials": per_launch(("receptor_partials",),
                                             samplings),
            "receptors_reduce": per_launch(("receptor_reduce",), samplings),
            "fluxes": per_launch(("fluxes_kernel",), nsteps),
            "conccalc_both_grids": per_launch(
                ("conccalc_kernel",), launches["conccalc"] + samplings),
            "reorder": per_launch(SORT_KERNELS, a["sorts"])},
        top=[dict(name=k[:60], calls=c, ms=ms) for k, c, ms in rows[:10]])
    del sim, fill
    shutil.rmtree(SIM_DF_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def sim_initcond_run_checks(sim, what: str, released: float) -> tuple:
    """sim_backward_run_checks, and the initial-condition sensitivity: with
    no particle ended (the globe holds them all), the grid is the scatter
    of every particle once at the run's end: each cell against the float64
    sum of the pairs of the plain version (held_against_f64, K17's rule),
    and those pairs, per species, sum to the particles' mass over the
    density at them within rtol 1e-6 (every particle counted once);
    grid_initial_001 and _002 written; trajectories.txt with its header
    and one line per output."""
    import torch
    from flexpart_tpu_torch.grid import initcond as ic
    out, last, conc = sim_backward_run_checks(sim, what, released)
    pa = sim.particles
    _, z1, _, _ = sim._fields_for(sim.last_itime)
    sim.close()                       # the reader that _fields_for woke
    oh = torch.tensor(sim.outgrid.outheights, dtype=torch.float32,
                      device=pa.device)
    lin, valid, contrib = ic.initcond_pairs(pa, pa.active, z1, oh, sim.ic_cfg)
    lin, contrib = lin[valid], contrib[valid]
    held = held_against_f64({"kernel": sim.init_cond.view(-1, pa.nspec)},
                            lin, contrib, K17_RTOL, f"{what} grid_initial")
    rho = ic.rho_at(pa, z1).double()
    want = (pa.mass.double() / rho[:, None])[pa.active].sum(0)
    pairs_sum = contrib.double().sum(0)
    check(bool(torch.all((pairs_sum - want).abs() <= 1e-6 * want)),
          f"{what}: the pairs hold {pairs_sum.tolist()}, the particles "
          f"{want.tolist()}")
    del lin, contrib, valid
    d = Path(sim.outdir)
    files = sorted(q.name for q in d.glob("grid_initial_*"))
    check(files == ["grid_initial_001", "grid_initial_002"],
          f"{what}: {files}")
    lines = (d / "trajectories.txt").read_text().splitlines()
    outputs = len(list(d.glob("grid_conc_*.npz")))
    check(len(lines) == 4 + outputs and outputs > 0,
          f"{what}: trajectories.txt has {len(lines)} lines")
    out.update(init_cond_sum=sim.init_cond.double().sum(
        dim=(0, 1, 2, 3)).tolist(), init_cond_particles=want.tolist(),
        init_cond_held=held, trajectory_lines=lines[4:])
    return out, last, conc


def phase_sim_initcond(device, kernels) -> dict:
    """The sensitivity to the initial condition of a backward run through
    ``Simulation.run`` at full width: sim_backward's configuration with
    linit_cond = 1 and iout = 5 (plume trajectories, clustered on the card),
    twice with one seed (run_twice, with sim_initcond_run_checks): the
    backward path's kernels and K17 (once a step on the particles that
    ended in it, none here, and once at the end on the survivors), the two
    runs bitwise equal; a third run, neither timed nor profiled and bitwise
    run B, counts each K17 call's masked particles and the grid rows their
    pairs hit, for K17's bound on the path."""
    import shutil
    import torch
    from flexpart_tpu_torch.grid import initcond as ic
    shutil.rmtree(SIM_IC_DIR, ignore_errors=True)
    nsteps = SIM_HOURS * 3600 // LSYNC

    def setup(run):
        return sim_backward_setup(SIM_IC_DIR / run, device, False,
                                  profile=run == "b",
                                  cmd_kw=dict(linit_cond=1, iout=5))

    sim, rows, a = run_twice(setup, kernels, "sim_initcond", 1.0,
                             IC_PATH_KERNELS,
                             run_checks=sim_initcond_run_checks)
    # K17's calls counted in a third run, neither timed nor profiled: the
    # particles each one masked and the grid rows their pairs hit
    masked, inner = [], ic.initcond_cuda

    def counting(grid, p, mask, zf, oh, cfg):
        lin, valid, _ = ic.initcond_pairs(p, mask, zf, oh, cfg)
        masked.append((int(mask.sum()), int(valid.sum()),
                       int(torch.unique(lin[valid]).numel())))
        inner(grid, p, mask, zf, oh, cfg)

    sim_c = setup("c")
    ic.initcond_cuda = counting
    try:
        sim_c.run()
    finally:
        ic.initcond_cuda = inner
    check_same_bits(sim.particles, sim_c.particles,
                    "sim_initcond: the counting run and run B")
    del sim_c
    launches = a["launches"]
    check(launches["initcond"] == nsteps + 1
          and launches["advance"] == nsteps and len(masked) == nsteps + 1,
          f"sim_initcond: {launches} launches in {nsteps} steps")
    device_ms, per_launch = per_launch_of(rows)
    # K17's bound on the path (kernel_initcond's count) for each call
    bounds = [k17_bound(sim.particles.capacity, m, sim.particles.nspec,
                        cells) for m, _, cells in masked]
    res = dict(
        n=N_MAIN, steps=nsteps, **a, device_ms_all_kernels=device_ms,
        device_per_call={
            "initcond": per_launch(("initcond_kernel",), nsteps + 1),
            "advance": per_launch(("advance_kernel",), nsteps)},
        initcond_masked_pairs_cells_per_call=masked,
        initcond_bound_last_call=bounds[-1],
        initcond_bound_ms_per_call=sum(b["bound_ms"] for b in bounds)
        / len(bounds),
        top=[dict(name=k[:60], calls=c, ms=ms) for k, c, ms in rows[:10]])
    del sim
    shutil.rmtree(SIM_IC_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return res

def phase_sim_bkdep(device, kernels) -> dict:
    """The backward deposition modes through ``Simulation.run`` on the
    card: one short run (BKDEP_STEPS steps of 900 s, N_BKDEP particles
    released at the receptor time in the storm band, output every half
    hour, sim_backward_setup)
    of each of ``ind_receptor`` 3 (WETBKDEP: the full 0-20 km column, the
    factor from K9 BKDEP) and 4 (DRYBKDEP: the 0-30 m layer, K10 BKDEP),
    and of WETBKDEP once more with ``use_clwc`` (SyntheticMet's cloud
    water: K9 BKDEP x CLWC), the launch counts set to 0 just before each
    and read just after.
    After the first step (a probe at the top of the second) every factor
    is assigned (xscav >= 0) and none is pending; WETBKDEP: the aerosol's
    factor positive for some particles (its clouds rain there), the
    tracer's 0 (it is not scavenged) and its mass zeroed, and
    wetscav_precip.txt holds one line per met time read; DRYBKDEP: the
    aerosol's factor its dryvel within rtol 1e-5; both sample through
    K3 BKDEP into finite, non-negative residence times."""
    import shutil
    import numpy as np
    import torch
    res = {}
    for mode, name, clwc in ((3, "wetbkdep", False), (4, "drybkdep", False),
                             (3, "wetbkdep_clwc", True)):
        out = SIM_BKDEP_DIR / name
        shutil.rmtree(out, ignore_errors=True)
        sim = sim_backward_setup(out, device, False, n=N_BKDEP, hours=1,
                                 ind_receptor=mode, release_hours=0,
                                 lout=1800, use_clwc=clwc)
        check(sim.bkdep == mode and sim._bkdep_pending,
              f"sim_bkdep {name}: bkdep {sim.bkdep}")
        after_first = {}

        def probe(istep, itime, s=sim, seen=after_first):
            if istep == 1:
                xs = s.particles.xscav[s.particles.active]
                seen.update(min_xscav=float(xs.min()),
                            pending=s._bkdep_pending)

        sim._step_probe = probe
        launches, run_s = counted_run(kernels, sim.run)
        entry = ("drydepo.bkdep" if mode == 4 else
                 "wetdepo.bkdep_clwc" if clwc else "wetdepo.bkdep")
        check(launches[entry] == 1 and launches["conccalc.bkdep"] > 0
              and launches["conccalc"] == 0
              and launches["redist.backward"] == BKDEP_STEPS + 1,
              f"sim_bkdep {name}: launches {launches}")
        check(after_first.get("min_xscav", -1.0) >= 0.0
              and after_first.get("pending") is False,
              f"sim_bkdep {name}: after the first step {after_first}")
        p = sim.particles
        xs = p.xscav[p.active]
        r = dict(run_s=run_s, launches=launches, **after_first,
                 released=N_BKDEP, active=int(p.active.sum()),
                 positive_factors=[int((xs[:, s] > 0).sum())
                                   for s in range(p.nspec)])
        if mode == 3:
            check(r["positive_factors"][1] > 0,
                  f"sim_bkdep {name}: no positive wet factor")
            check(r["positive_factors"][0] == 0
                  and float(p.mass[:, 0].abs().sum()) == 0.0,
                  f"sim_bkdep {name}: the tracer kept a factor or mass")
            # one line per release box and met time read
            lines = (out / "wetscav_precip.txt").read_text().splitlines()
            check(len(lines) >= 2 and all(len(ln.split()) == 6
                                          for ln in lines),
                  f"sim_bkdep {name}: wetscav_precip.txt {lines}")
            r["precip_lines"] = lines
        else:
            dryvel = sim.releases.species[1].dryvel
            err = float((xs[:, 1] - dryvel).abs().max())
            check(err <= 1e-5 * dryvel,
                  f"sim_bkdep {name}: factor off dryvel by {err}")
            r["factor_max_abs_err_from_dryvel"] = err
        npz = sorted(out.glob("grid_conc_*.npz"))
        check(len(npz) >= 1, f"sim_bkdep {name}: no output")
        conc = np.load(npz[-1])["conc"]
        check(bool(np.isfinite(conc).all()) and float(conc.min()) >= 0.0
              and float(conc[1].max()) > 0.0,
              f"sim_bkdep {name}: conc not finite, negative or all 0")
        r["conc_max_per_species"] = [float(conc[s].max())
                                     for s in range(conc.shape[0])]
        res[name] = r
        del sim, p, xs
        shutil.rmtree(out, ignore_errors=True)
        torch.cuda.empty_cache()
    return res


SIM_OH_DIR = ROOT / "build" / "sim_oh_split_smoke"
# sim's 10 x 2**20 particles with room for 2 x 2**20 children
OH_CAPACITY = 12 * 2 ** 20
OH_BDATE = (20200701, 100000)   # 10:00 UTC: daylight over both boxes
N_WARM_BOX = 2 ** 10            # run C's own release beside the dump


def sim_oh_split_setup(outdir, device, hours: int = SIM_HOURS, ipin=0,
                       parts=None, **kw):
    """The sim phase's configuration on OH_DATE from 10:00 UTC (its boxes
    at 0-30 E in daylight, where the hourly OH is not zero; at the sim
    phase's January midnight there is none), species 0 made the REACT
    species of the JAX package's test (tests/test_physics.py:139), the
    Cs-137-like aerosol as species 1; capacity OH_CAPACITY, itsplit =
    3600, ipout = 2 (partposit_end), no netCDF.  ``parts``: the particles
    of each box (the sim phase's by default)."""
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch.config import (Command, ReleaseBox, Releases,
                                           Species)
    grid = make_grid(**SIM_GRID)
    _, rel, og = sim_config()
    day, t0 = OH_BDATE
    cmd = Command(ibdate=day, ibtime=t0, iedate=day,
                  ietime=t0 + hours * 10000, lsynctime=LSYNC,
                  loutstep=3600, loutaver=3600, loutsample=900,
                  itsplit=3600, ipout=2, ipin=ipin)
    boxes = tuple(
        ReleaseBox(**{**{k: getattr(b, k) for k in (
            "lon1", "lon2", "lat1", "lat2", "z1", "z2", "mass")},
            "idate1": day, "itime1": t0, "idate2": day,
            "itime2": t0 + 10000,
            "parts": b.parts if parts is None else parts})
        for b in rel.boxes)
    species = (Species(name="REACT", ohcconst=1.0e-11, ohdconst=500.0,
                       ohnconst=0.0), rel.species[1])
    return Simulation(cmd=cmd, releases=Releases(species=species,
                                                 boxes=boxes),
                      grid=grid, met_backend=SyntheticMet(grid), outgrid=og,
                      outdir=str(outdir), device=device, write_netcdf=False,
                      **kw)


def phase_sim_oh_split(device, kernels) -> dict:
    """Particle dumps, warm start, checkpoints, OH chemistry (K12) and
    splitting (K13) through ``Simulation.run`` at full width
    (sim_oh_split_setup), three runs:

    A, straight through with a checkpoint at 3600 s, timed, its launch
      counts set to 0 just before and read just after: K12 every step
      but the first, K13 at the two outputs past itsplit (5400 and 9000
      s: the first grants the 2 x 2**20 free slots to the 5 x 2**20 due,
      the capacity guard), K5 once per sort (a sort after each split);
      every particle active and finite, the aerosol's budget within
      1e-3 (the split halves both masses), the REACT species' airborne
      mass below its release (OH);
    B, resumed from A's checkpoint at 3600 s: its final particles bit
      for bit A's, its partposit_end byte for byte A's; on its steps K12
      and K13 held against their plain versions on the inputs the run
      gives them (K12 on the first step's OH, the REACT species losing
      mass; K13 on both splits: granted = min(due, free), the live mass
      within rtol 1e-6);
    C, a warm start (ipin = 1) from A's partposit_end for one hour, with
      N_WARM_BOX particles of its own: the appended particles equal the
      file's in count and mass, bit for bit, and all of them live to the
      end."""
    import shutil
    import numpy as np
    import torch
    from flexpart_tpu_torch.core import split as sp
    from flexpart_tpu_torch.core.state import FIELDS
    from flexpart_tpu_torch.io import partdump
    from flexpart_tpu_torch.physics import ohchem
    from flexpart_tpu_torch.run import simulation as simmod
    shutil.rmtree(SIM_OH_DIR, ignore_errors=True)
    ck = SIM_OH_DIR / "checkpoint.npz"
    res = {}

    # run A
    t0 = time.perf_counter()
    sim = sim_oh_split_setup(SIM_OH_DIR / "a", device, capacity=OH_CAPACITY,
                             checkpoint_at=3600, checkpoint_path=str(ck))
    setup_s = time.perf_counter() - t0
    launches, run_s = counted_run(kernels, sim.run)
    nsteps = SIM_HOURS * 3600 // LSYNC
    counts = [c.tolist() for c in sim.split_counts]
    check(launches["ohreaction"] == nsteps and launches["split"] == 2
          and launches["reorder"] == sim.n_sorts
          and all(launches[k] > 0 for k in FIXED_PATH_KERNELS),
          f"sim_oh_split A: launches {launches}")
    check(len(counts) == 2 and all(c[2] == min(c[0], c[1]) for c in counts)
          and counts[0][0] > counts[0][1] > 0,
          f"sim_oh_split A: splits (due, free, granted) {counts}")
    pa = sim.particles
    n_live = int(pa.active.sum())
    check(n_live == N_MAIN + sum(c[2] for c in counts) == OH_CAPACITY,
          f"sim_oh_split A: {n_live} active")
    for f in ("x_hi", "x_lo", "y_hi", "y_lo", "z", "mass"):
        check(bool(torch.isfinite(getattr(pa, f)).all()),
              f"sim_oh_split A: {f} not finite")
    released = 2.0            # the aerosol: one unit from each box
    aero = dict(
        airborne=float(pa.mass[pa.active, 1].sum(dtype=torch.float64)),
        wet=float(sim.acc.wetgridunc[..., 1].sum(dtype=torch.float64)),
        dry=float(sim.acc.drygridunc[..., 1].sum(dtype=torch.float64)))
    aero["sum"] = aero["airborne"] + aero["wet"] + aero["dry"]
    check(abs(aero["sum"] - released) <= 1e-3 * released,
          f"sim_oh_split A: aerosol budget {aero}")
    react = float(pa.mass[pa.active, 0].sum(dtype=torch.float64))
    react_wet_dry = float(sim.acc.wetgridunc[..., 0].sum()
                          + sim.acc.drygridunc[..., 0].sum())
    check(react < 1.0 and react_wet_dry == 0.0,
          f"sim_oh_split A: REACT airborne {react}, deposits "
          f"{react_wet_dry}")
    end_a = (SIM_OH_DIR / "a" / "partposit_end").read_bytes()
    res["run_a"] = dict(
        setup_s=setup_s, run_s=run_s, launches=launches,
        particle_steps=sim.timings["particle_steps"],
        particle_steps_per_s_whole_run=sim.timings["particle_steps"] / run_s,
        section_seconds_unsynced={k: v for k, v in sim.timings.items()
                                  if k != "particle_steps"},
        splits_due_free_granted=counts, sorts=sim.n_sorts, active=n_live,
        aerosol_budget=aero, react_airborne=react,
        react_oh_loss=1.0 - react, partposit_end_bytes=len(end_a),
        checkpoint_bytes=ck.stat().st_size)
    pa = {f: getattr(pa, f) for f in FIELDS}
    del sim

    # run B: resumed, K12 and K13 held on the run's own inputs
    held = {"ohreaction": [], "split": []}
    t0 = time.perf_counter()
    sim = sim_oh_split_setup(SIM_OH_DIR / "b", device, capacity=OH_CAPACITY)
    start = sim.load_checkpoint(ck)
    check(start == 3600, f"sim_oh_split B: checkpoint at {start}")
    load_s = time.perf_counter() - t0
    oh_kernel = sim._ohreaction

    def oh_held(p, *args):
        out = oh_kernel(p, *args)
        if not held["ohreaction"]:
            pl = ohchem.ohreaction_plain(p, oh_kernel.grid, *args)
            check_same_bits(out, pl, "sim_oh_split B: K12", ("mass",))
            lost = float((p.mass[:, 0].double() - out.mass[:, 0].double())
                         .sum())
            check(lost > 0.0, f"sim_oh_split B: K12 lost {lost}")
            held["ohreaction"].append(dict(
                itime=args[4], react_mass_lost=lost, bitwise=True,
                ms=cuda_ms(lambda: oh_kernel(p, *args), 3),
                plain_ms=cuda_ms(lambda: ohchem.ohreaction_plain(
                    p, oh_kernel.grid, *args), 1)))
        return out

    inner = simmod.split_particles

    def split_held(p, itime, ldirect, origin):
        q = clone_particles(p)
        m0 = p.mass[p.active].double().sum(0)
        out, counts = inner(p, itime, ldirect, origin)
        pl, cp = sp.split_particles_plain(clone_particles(q), itime,
                                          ldirect, origin)
        check(counts.tolist() == cp.tolist(),
              f"sim_oh_split B: K13 counts {counts.tolist()} / "
              f"{cp.tolist()}")
        check_same_bits(out, pl, f"sim_oh_split B: K13 at {itime}", FIELDS)
        c = cp.tolist()
        m1 = out.mass[out.active].double().sum(0)
        check(c[2] == min(c[0], c[1])
              and bool(torch.all((m1 - m0).abs() <= 1e-6 * m0)),
              f"sim_oh_split B: split at {itime} {c}, mass {m0.tolist()} "
              f"-> {m1.tolist()}")
        parents, children = split_pairs(q, out)
        prof = profiled_in_place(
            lambda: clone_particles(q),
            lambda x: sp.split_particles(x, itime, ldirect, origin))
        held["split"].append(dict(
            itime=itime, due_free_granted=c, bitwise=True,
            mass_rel_change=float(((m1 - m0).abs() / m0).max()),
            ms=graph_on_copy_ms(q, lambda x: sp.split_particles(
                x, itime, ldirect, origin)),
            profiled_ms=prof["device_ms"], per_launch=prof["per_launch"],
            **k13_bounds(q, itime, ldirect, origin is not None, parents,
                         children)))
        return out, counts

    sim._ohreaction = oh_held
    simmod.split_particles = split_held
    try:
        t1 = time.perf_counter()
        sim.run(start_itime=start)
        run_b_s = time.perf_counter() - t1
    finally:
        simmod.split_particles = inner
    check(len(held["split"]) == 2 and held["ohreaction"],
          f"sim_oh_split B: held {held}")
    for f in FIELDS:
        a, b = pa[f], getattr(sim.particles, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"sim_oh_split B: {f} differs from A's")
    check((SIM_OH_DIR / "b" / "partposit_end").read_bytes() == end_a,
          "sim_oh_split B: partposit_end differs from A's")
    res["run_b"] = dict(load_s=load_s, run_s=run_b_s, start_itime=start,
                        particles_bitwise_equal_a=True,
                        partposit_end_equal_a=True, held=held)
    del sim, pa

    # run C: a warm start from A's partposit_end
    (SIM_OH_DIR / "c").mkdir(parents=True)
    shutil.copy(SIM_OH_DIR / "a" / "partposit_end", SIM_OH_DIR / "c")
    t0 = time.perf_counter()
    _, dump = partdump.read_partposit(SIM_OH_DIR / "a" / "partposit_end", 2)
    n_warm = len(dump["z"])
    sim = sim_oh_split_setup(SIM_OH_DIR / "c", device, hours=1, ipin=1,
                             parts=N_WARM_BOX // 2)
    setup_c = time.perf_counter() - t0
    pc = sim.particles
    check(pc.capacity == N_WARM_BOX + n_warm == N_WARM_BOX + OH_CAPACITY,
          f"sim_oh_split C: {pc.capacity} slots for {n_warm} dumped")
    want = torch.as_tensor(dump["mass"].astype(np.float32), device=device)
    check(torch.equal(pc.mass[N_WARM_BOX:].view(torch.int32),
                      want.view(torch.int32)),
          "sim_oh_split C: the warm particles' masses differ from the file's")
    t1 = time.perf_counter()
    sim.run()
    run_c_s = time.perf_counter() - t1
    n_c = int(sim.particles.active.sum())
    check(n_c == N_WARM_BOX + n_warm,
          f"sim_oh_split C: {n_c} active of {N_WARM_BOX} + {n_warm}")
    res["run_c"] = dict(setup_s=setup_c, run_s=run_c_s, dumped=n_warm,
                        active=n_c, masses_equal_file=True)
    del sim, pc
    shutil.rmtree(SIM_OH_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    res["launches"] = res["run_a"]["launches"]
    return res


def make_sim_grid():
    from flexpart_tpu_torch.met import make_grid
    return make_grid(**SIM_GRID)


def interp_tables(z0, z1, tw, cfg):
    from flexpart_tpu_torch.core import interp
    return interp.build_step_tables_quad(z0, z1, *tw, dtype=cfg.table_dtype)


def phase_legacy(device) -> dict:
    """The legacy-RNG validation path (every draw of the advance from the
    reference's rannumb table in the serial ran3 order) has no kernel and
    runs on the CPU only, where tests/test_torch_matched_*.py hold it
    against the advance.f90 oracles: on the card ``Simulation(legacy_rng=
    True)`` must refuse it by name before it writes anything, and so must
    ``advance_all`` with legacy draws on CUDA tensors."""
    import shutil
    import torch
    from flexpart_tpu_torch import Simulation, SyntheticMet, make_grid
    from flexpart_tpu_torch.config import (Command, OutGrid, ReleaseBox,
                                           Releases, Species)
    from flexpart_tpu_torch.core import advance, rng
    from flexpart_tpu_torch.core.legacy import LegacyRnd
    out = ROOT / "build" / "legacy_smoke"
    shutil.rmtree(out, ignore_errors=True)
    grid = make_grid(nx=73, ny=37, nlev=20, dx=5.0, dy=5.0)
    cmd = Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=3000,
                  lsynctime=LSYNC, loutstep=1800, loutaver=1800,
                  loutsample=LSYNC)
    box = ReleaseBox(idate1=20200101, itime1=0, idate2=20200101, itime2=0,
                     lon1=0.0, lon2=2.0, lat1=40.0, lat2=42.0, z1=50.0,
                     z2=500.0, mass=(1.0,), parts=1024)
    og = OutGrid(outlon0=-60.0, outlat0=0.0, numxgrid=60, numygrid=40,
                 dxout=2.0, dyout=2.0, outheights=(500.0, 2000.0, 50000.0))
    refused = {}
    try:
        Simulation(cmd=cmd, releases=Releases(species=(Species(),),
                                              boxes=(box,)),
                   grid=grid, met_backend=SyntheticMet(grid), outgrid=og,
                   outdir=str(out), device=device, legacy_rng=True)
    except NotImplementedError as err:
        refused["simulation"] = str(err)
    check("legacy_rng" in refused.get("simulation", ""),
          "legacy: Simulation(legacy_rng=True) on the card was not refused")
    check(not out.exists(), "legacy: the refused run wrote its directory")
    cfg, prm, *_ = step_setup(grid)
    (z0,) = met_fields("uniform", grid, device)
    p = bench_particles(1024, device, seed=3)
    ones = torch.ones(p.capacity, dtype=torch.int32, device=device)
    leg = LegacyRnd(table=torch.zeros(101, device=device), nrand_init=ones,
                    nrand=ones)
    try:
        advance.advance_all(p, z0, z0, 0, 0, 3600, rng.Key(1, 0), cfg, prm,
                            leg=leg)
    except NotImplementedError as err:
        refused["advance_all"] = str(err)
    check("legacy" in refused.get("advance_all", ""),
          "legacy: advance_all took legacy draws on the card")
    return dict(refused_on_the_card=refused)


# ------------------------------------------------------------------ main --

def main() -> int:
    t_script = time.perf_counter()
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
    # the disassembly the bounds read (k11_instructions,
    # settling_instructions, sass_paths): cuobjdump of each library as
    # soon as it is built, while the others still build, and all of it
    # before any timing: its processes would take the host's cores from
    # the launches that a kernel's time includes
    dis = [(k, flag) for k in (_build.ADVANCE, _build.ADVANCE_ADAPTIVE,
                               _build.WETDEPO, cbl_calls_build())
           for flag in ("-sass", "-elf")]

    def disassemble(k):
        for kd, flag in dis:
            if kd is k:
                k.cuobjdump(flag, wait=False)

    build_s = _build.build_all(kernels + [cbl_calls_build()],
                               on_built=disassemble)
    # every launch count: the kernels' and their instantiations' entries
    counted = kernels + list(_build.ENTRIES)
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln] for k in kernels}
    emit({"phase": "build", "seconds": build_s,
          "nvcc_ended_s": {k.name: k.build_s for k in kernels},
          "ptxas": ptxas,
          "registers": {k.name: ptxas_by_entry(k.build_log)
                        for k in kernels}})

    # the rest of the disassembly, after the build
    t0 = time.perf_counter()
    for k, flag in dis:
        k.cuobjdump(flag)
    emit({"phase": "disassembly", "seconds": time.perf_counter() - t0})

    grid = make_grid(**BENCH_GRID)
    t0 = time.perf_counter()
    kres = phase_kernels(device, grid)
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0, **kres,
          "power_limit": smi})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ohk = {"ohreaction": kernel_ohreaction(device, grid),
           "split": kernel_split(device, grid, OH_CAPACITY)}
    emit({"phase": "kernels_oh_split", "seconds": time.perf_counter() - t0,
          **ohk, "power_limit": smi})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dfk = {"domainfill": kernel_boundcond(device, grid),
           "receptors": kernel_receptors(device, grid),
           "fluxes": kernel_fluxes(device, grid),
           "initcond": kernel_initcond(device, grid)}
    emit({"phase": "kernels_domainfill", "seconds": time.perf_counter() - t0,
          **dfk, "power_limit": smi})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    sres = phase_step(device, grid)
    emit({"phase": "step", "seconds": time.perf_counter() - t0, **sres})
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    rres = phase_reorder(device, grid)
    emit({"phase": "reorder", "seconds": time.perf_counter() - t0, **rres,
          "device": name, "power_limit": smi})
    torch.cuda.empty_cache()

    normals_other = _build.NORMALS.launches
    mres, pres = phase_main(device, grid, counted)
    emit({"phase": "main", **mres,
          "cuda_kernels_per_step": pres["cuda_kernels_per_step"],
          "device": name, "power_limit": smi})
    emit({"phase": "profile", **pres, "device": name, "power_limit": smi})
    del pres
    torch.cuda.empty_cache()

    # the launches of the kernels line stay the main phase's; the sim phase
    # resets the counts for its own run and reports them in its line
    t0 = time.perf_counter()
    held = {}
    simres = phase_sim(device, counted, held)
    emit({"phase": "sim", "seconds": time.perf_counter() - t0, **simres,
          "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    npzres = phase_sim_npz(device, counted, held, simres)
    emit({"phase": "sim_npz", "seconds": time.perf_counter() - t0, **npzres,
          "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    grres = phase_sim_grib(device, counted, simres, npzres)
    emit({"phase": "sim_grib", "seconds": time.perf_counter() - t0, **grres,
          "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    gfres = phase_sim_gfs(device, counted)
    emit({"phase": "sim_gfs", "seconds": time.perf_counter() - t0, **gfres,
          "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    adres = phase_sim_adaptive(device, counted)
    emit({"phase": "sim_adaptive", "seconds": time.perf_counter() - t0,
          **adres, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    cblres = phase_sim_cbl(device, counted)
    emit({"phase": "sim_cbl", "seconds": time.perf_counter() - t0,
          **cblres, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    nres = phase_sim_nested(device, counted)
    emit({"phase": "sim_nested", "seconds": time.perf_counter() - t0,
          **nres, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    bres = phase_sim_backward(device, counted)
    emit({"phase": "sim_backward", "seconds": time.perf_counter() - t0,
          **bres, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    kres_bk = phase_sim_bkdep(device, counted)
    emit({"phase": "sim_bkdep", "seconds": time.perf_counter() - t0,
          **kres_bk, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    ohres = phase_sim_oh_split(device, counted)
    emit({"phase": "sim_oh_split", "seconds": time.perf_counter() - t0,
          **ohres, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    dfres = phase_sim_domainfill(device, counted)
    emit({"phase": "sim_domainfill", "seconds": time.perf_counter() - t0,
          **dfres, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    icres = phase_sim_initcond(device, counted)
    emit({"phase": "sim_initcond", "seconds": time.perf_counter() - t0,
          **icres, "device": name, "power_limit": smi})

    t0 = time.perf_counter()
    lres = phase_legacy(device)
    emit({"phase": "legacy", "seconds": time.perf_counter() - t0, **lres,
          "device": name, "power_limit": smi})

    # launches: the main path's own count.  The normals kernel is not
    # launched there: its generator (fp::normal_words, fp::normal_pair) runs
    # inside the advance kernel's one launch; the stand-alone kernel serves
    # rng.normals.
    src = "flexpart_tpu_torch/csrc/{}.cu"
    replaces = {"normals": ("flexpart_tpu/core/rng.py:61", "pallas"),
                "quad_tables": ("flexpart_tpu/core/interp.py:457", "XLA"),
                "conccalc": ("flexpart_tpu/grid/conccalc.py:78", "XLA"),
                "advance": ("flexpart_tpu/core/advance.py:768", "XLA"),
                # the JAX package keeps no particle order; its tiles mode
                # moves particles between slots here
                "reorder": ("flexpart_tpu/parallel/domain.py:151", "none"),
                "convection": ("flexpart_tpu/physics/convection.py:379",
                               "XLA"),
                "redist": ("flexpart_tpu/physics/convection.py:453", "XLA"),
                "depo_scatter": ("flexpart_tpu/physics/wetdepo.py:168",
                                 "XLA"),
                # wetscav_all, and apply_wetdepo at massupdate.py:32
                "wetdepo": ("flexpart_tpu/physics/wetdepo.py:75", "XLA"),
                "drydepo": ("flexpart_tpu/physics/massupdate.py:54", "XLA"),
                # advance_all with method=1: _adaptive_interval (:430-660),
                # _ldt_formula (:414) and the first step (:936-954)
                "advance_adaptive": ("flexpart_tpu/core/advance.py:430",
                                     "XLA")}
    k5 = kres["reorder"]["cases"]
    extra = {"reorder": {
        # per input: K5, the plain version, torch.argsort of the keys, the
        # byte bound; the shuffled input's bound by 32 B sectors beside it
        "inputs": {n: {f: c[f] for f in ("ms", "plain_ms", "library_ms",
                                        "bound_ms") } for n, c in k5.items()},
        "shuffled_sector_bound_ms": k5["shuffled"]["sector_bound_ms"]},
        "normals": {
        "on_main_path_as": "fp::normal_words and fp::normal_pair of "
                           "flexpart_tpu_torch/csrc/philox_normal.cuh, "
                           "inlined into advance.cu",
        "launches_other_phases": normals_other},
        "conccalc": {
            # of the steady step's case: the 4-point path, ordered, all old
            "global_atomics_without_warp_sums":
                kres["conccalc"]["cases"]["kernel_ordered_all_old"]["pairs"],
            "global_atomics": kres["conccalc"]["cases"]
                ["kernel_ordered_all_old"]["warp_target_pairs"]},
        # the POLAR instantiation on the whole sphere; main keeps it off
        "advance": {"polar": {f: kres["advance"]["polar"][f] for f in (
            "ms", "unordered_ms", "stock_ms_same_particles", "plain_ms",
            "bound_ms", "bound_by", "max_abs_err", "bitwise", "branches")},
            # the SETTLING instantiation beside the stock one on the same
            # particles, and on the sim_adaptive phase's kept steps
            "settling": {
                **{f: kres["advance"]["settling"][f] for f in (
                    "ms", "unordered_ms", "stock_ms_same_particles",
                    "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                    "bitwise", "differing_particles",
                    "aerosol_mean_drop_against_stock_m", "library_ms",
                    "settling_instructions", "bound_bytes",
                    "bound_operations", "bound_instructions")},
                "sim_adaptive_inputs": {
                    s: {f: r["advance_settling"][f] for f in (
                        "ms", "plain_ms", "max_abs_err",
                        "differing_particles")}
                    for s, r in adres["kernels_on_sim_adaptive_inputs"]
                    .items()}}},
        # K11: the spread ensemble in cell order (ms) and as drawn, its
        # passes and warp efficiency, the compiled kernel's instructions per
        # pass, its time per call in the sim_adaptive run and on its kept
        # steps
        "advance_adaptive": {
            **{f: kres["advance_adaptive"][f] for f in (
                "unordered_ms", "bitwise", "lane_efficiency",
                "warp_efficiency_pooled", "warp_efficiency", "passes_mean",
                "passes_p99", "passes_max", "instructions", "bound_bytes",
                "bound_operations", "bound_instructions", "ragged")},
            **{f"unordered_{f}": kres["advance_adaptive"]["cases"]
               ["as_drawn"][f] for f in ("lane_efficiency",
                                         "warp_efficiency_pooled",
                                         "warp_efficiency")},
            "sim_adaptive": {f: adres[f] for f in (
                "passes_per_pbl_particle_mean", "passes_per_pbl_particle_p99",
                "passes_per_pbl_particle_max", "lane_efficiency_run",
                "warp_efficiency_pooled_run", "warp_efficiency_mean")},
            "sim_adaptive_per_call": adres["device_per_call"]
            ["advance_adaptive"],
            "sim_adaptive_inputs": {
                s: {f: r["advance_adaptive"][f] for f in (
                    "ms", "plain_ms", "max_abs_err", "differing_particles",
                    "lane_efficiency", "warp_efficiency_pooled",
                    "warp_efficiency", "passes_mean",
                    "passes_max", "instructions_per_pass", "bound_ms",
                    "bound_by", "aerosol_drop_by_settling_m")}
                for s, r in adres["kernels_on_sim_adaptive_inputs"].items()}},
        # K6: SyntheticMet (ms) and the sounding, every column convecting
        # (all_convecting_ms); its layout on this card; the taller grids
        "convection": {
            **{f: kres["convection"][f] for f in (
                "library", "all_convecting_ms", "nl", "L1", "columns",
                "layout", "values_differ")},
            "tall": {n: {f: t[f] for f in ("L1", "columns_per_block",
                                           "warps_per_sm", "registers")}
                     for n, t in kres["convection"]["tall"].items()}},
        # K7: ms on SyntheticMet's matrices in cell order, the run's order;
        # unordered beside it, and the sounding's (all convecting)
        "redist": {f: kres["redist"][f] for f in (
            "library", "moved", "unordered_ms",
            "unordered_bound_ms", "all_convecting_ms",
            "all_convecting_bound_ms", "all_convecting_unordered_ms")}}
    for kname in ("convection", "redist"):
        extra[kname]["convecting_columns"] = {
            n: c["convecting_columns"]
            for n, c in kres["convection"]["cases"].items()}
    # each kernel against its plain version on the two steps kept from the
    # sim phase (the sampling: the step's own path)
    for kname in ("quad_tables", "conccalc", "advance", "reorder",
                  "convection", "redist", "wetdepo", "drydepo",
                  "depo_scatter"):
        on_sim = {}
        for step, r in simres["kernels_on_sim_inputs"].items():
            r = r[kname]
            if kname == "conccalc":
                r = next(c for c in r.values() if c["the_steps_own_path"])
            pick = ("max_abs_err", "ms", "plain_ms") + (
                ("library_ms",) if kname == "conccalc" else ())
            if kname == "depo_scatter":      # the wet and the dry deposit
                on_sim[step] = {k: {f: c[f] for f in pick}
                                for k, c in r.items()}
            else:
                on_sim[step] = {f: r[f] for f in pick}
        extra.setdefault(kname, {})["sim_inputs"] = on_sim
    # K8-K10: the cases of the kernels phase (ms is the run's case: cell
    # order; K9 on SyntheticMet, K8 the dry deposit)
    for kname in ("wetdepo", "drydepo", "depo_scatter"):
        extra[kname]["ms_case"] = kres[kname]["ms_case"]
        extra[kname]["cases"] = {
            n: {f: c[f] for f in ("ms", "plain_ms", "library_ms",
                                  "max_abs_err", "pairs", "cells_hit",
                                  "most_pairs_in_a_cell")
                if f in c} for n, c in kres[kname]["cases"].items()}
        for f in ("bitwise", "values_differ"):
            if f in kres[kname]:
                extra[kname][f] = kres[kname][f]
    # K10's T_BELOW instantiation beside K10 on the same particles, per call
    # in the sim_adaptive run and on its kept steps
    extra["drydepo"]["t_below"] = {
        **kres["drydepo"]["t_below"],
        "sim_adaptive_per_call": adres["device_per_call"]["drydepo_t_below"],
        "sim_adaptive_inputs": {
            s: {f: r["drydepo_t_below"][f] for f in (
                "ms", "plain_ms", "max_abs_err", "values_differ", "bitwise")}
            for s, r in adres["kernels_on_sim_adaptive_inputs"].items()}}
    # K9's operation count: the compiled kernel's instructions per path and
    # the calls of the run's case
    extra["wetdepo"]["instructions"] = kres["wetdepo"]["instructions"]
    extra["wetdepo"]["path_calls"] = kres["wetdepo"]["cases"][
        kres["wetdepo"]["ms_case"]]["path_calls"]
    # the advance of a backward run (ldirf = -1), bitwise against its plain
    # version: stock K4 and POLAR, K11 and K11 CBL, each beside the
    # forward instantiation on the same particles
    extra["advance"]["backward"] = kres["advance"]["backward"]
    extra["advance_adaptive"]["backward"] = kres["advance_adaptive"][
        "backward"]
    extra["redist"]["sim_backward_per_call"] = bres["device_per_call"][
        "redist_backward"]

    def path_launches(kname):
        """A kernel's launches on the GRIB paths (sim_grib, sim_gfs) and
        the backward ones (sim_backward; each of sim_bkdep's runs)."""
        return {"launches_sim_grib": grres["launches"][kname],
                "launches_sim_gfs": gfres["launches"][kname],
                "launches_sim_backward": bres["launches"][kname],
                "launches_sim_bkdep": {m: r["launches"][kname]
                                       for m, r in kres_bk.items()}}

    # K12 and K13 run on sim_oh_split's path alone, K14-K16 on
    # sim_domainfill's and K17 on sim_initcond's: their launches are those
    # runs' A, and they have rows of their own below
    slice18 = ("ohreaction", "split", "domainfill", "receptors", "fluxes",
               "initcond")
    line = [
        {"name": k.name, "route": "cuda", "source": src.format(k.name),
         "replaces": replaces[k.name][0], "tpu_route": replaces[k.name][1],
         "launches": mres["launches"][k.name],
         "launches_sim": simres["launches"][k.name],
         "launches_sim_npz": npzres["launches"][k.name],
         "launches_sim_adaptive": adres["launches"][k.name],
         "launches_sim_domainfill": dfres["launches"][k.name],
         "launches_sim_initcond": icres["launches"][k.name],
         **path_launches(k.name),
         **{f: kres[k.name][f] for f in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")}, **extra.get(k.name, {})}
        for k in kernels if k.name not in slice18]
    # the two instantiations of this slice's paths, each with the launches
    # of its own path (its counts set to 0 just before the run)
    cbl, nst = kres["advance_adaptive"]["cbl"], kres["advance"]["nests"]
    pick = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line += [
        {"name": "advance_adaptive.cbl", "route": "cuda",
         "source": src.format("advance_adaptive"),
         # _pbl_vertical's cblflag branch (:321-381), core/cbl.py, the
         # fresh particle's skewed draw (:904-916)
         "replaces": "flexpart_tpu/core/advance.py:321", "tpu_route": "XLA",
         "launches": cblres["launches"]["advance_adaptive"],
         **path_launches("advance_adaptive"),
         **{f: cbl[f] for f in pick},
         **{f: cbl[f] for f in (
             "layout", "stock_k11_ms", "unordered_ms", "bitwise", "nan_count",
             "lane_efficiency", "passes_mean", "passes_max", "skewed_share",
             "instructions", "bound_bytes", "bound_operations",
             "bound_instructions", "bound_without_skewed_calls",
             "skewed_calls", "skewed_paths", "skewed_instructions",
             "share_of_bound")},
         "sim_cbl_per_call": cblres["device_per_call"]
         ["advance_adaptive_cbl"],
         "sim_cbl_inputs": cblres["kernels_on_sim_cbl_inputs"]},
        {"name": "advance.nests", "route": "cuda",
         "source": src.format("advance"),
         # advance_all's nest sampling (:841-866) and corrector (:1176-1189)
         "replaces": "flexpart_tpu/core/advance.py:841", "tpu_route": "XLA",
         "launches": nres["launches"]["advance"],
         **path_launches("advance"),
         **{f: nst[f] for f in pick},
         **{f: nst[f] for f in (
             "stock_k4_ms", "unordered_ms", "stock_k4_unordered_ms",
             "bitwise", "differing_particles", "nest_share", "nest_rows",
             "nest_particles_moved_otherwise_share", "bound_bytes")},
         "sim_nested_per_call": nres["device_per_call"]["advance_nests"],
         "quad_tables_sim_nested_per_call":
             nres["device_per_call"]["quad_tables"],
         "sim_nested_inputs": {
             s: {f: r[f] for f in ("ms", "plain_ms", "max_abs_err",
                                   "differing_particles")}
             for s, r in nres["kernels_on_sim_nested_inputs"].items()}}]
    # the instantiations of the backward runs, launched through entries of
    # their own (each counted apart): K7 BACKWARD on sim_backward's path,
    # the BKDEP ones on sim_bkdep's; COUNT on no Simulation path (the
    # reference never sets particle_count_output): its launches are the
    # main phase's, as every kernel's, and it is held in the kernels phase
    back = {
        "redist.backward": ("redist", "flexpart_tpu/physics/convection.py:479",
                            bres["launches"]["redist.backward"]),
        "conccalc.bkdep": ("conccalc", "flexpart_tpu/grid/conccalc.py:144",
                           sum(r["launches"]["conccalc.bkdep"]
                               for r in kres_bk.values())),
        "conccalc.count": ("conccalc", "flexpart_tpu/grid/conccalc.py:140",
                           mres["launches"]["conccalc.count"]),
        "wetdepo.bkdep": ("wetdepo", "flexpart_tpu/physics/bkdep.py:44",
                          kres_bk["wetbkdep"]["launches"]["wetdepo.bkdep"]),
        "drydepo.bkdep": ("drydepo", "flexpart_tpu/physics/bkdep.py:31",
                          kres_bk["drybkdep"]["launches"]["drydepo.bkdep"]),
        # the cloud-water instantiations: wetscav_all's use_clouds_water
        # branch (:118-121); K9 CLWC on sim_gfs's path, BKDEP x CLWC on
        # sim_bkdep's WETBKDEP run with use_clwc
        "wetdepo.clwc": ("wetdepo", "flexpart_tpu/physics/wetdepo.py:118",
                         gfres["launches"]["wetdepo.clwc"]),
        "wetdepo.bkdep_clwc": ("wetdepo", "flexpart_tpu/physics/bkdep.py:44",
                               kres_bk["wetbkdep_clwc"]["launches"]
                               ["wetdepo.bkdep_clwc"])}
    for ename, (lib, ref, n_launch) in back.items():
        r = kres[ename]
        line.append(
            {"name": ename, "route": "cuda", "source": src.format(lib),
             "replaces": ref, "tpu_route": "XLA", "launches": n_launch,
             **path_launches(ename),
             **({"on_a_path": "none: Simulation never sets "
                 "particle_count_output, as the reference; conccalc() "
                 "with it launches COUNT"} if ename == "conccalc.count"
                else {}),
             **{f: r[f] for f in pick},
             **{f: r[f] for f in ("n", "bound_bytes", "bound_operations",
                                  "stock_ms_same_particles",
                                  "k9_ms_same_particles",
                                  "k9_bkdep_ms_same_particles",
                                  "all_convecting_ms",
                                  "all_convecting_bound_ms", "moved",
                                  "instructions", "path_calls", "fresh",
                                  "zeroed", "positive", "unordered_ms",
                                  "bitwise", "cases") if f in r}})
    # K9 CLWC per call in sim_gfs and on its kept steps
    next(r for r in line if r["name"] == "wetdepo.clwc").update(
        sim_gfs_per_call=gfres["device_per_call"]["wetdepo_clwc"],
        sim_gfs_inputs={s: {f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                              "max_abs_err", "bitwise")}
                        for s, r in gfres["kernels_on_sim_gfs_inputs"]
                        .items()})
    nsteps_oh = SIM_HOURS * 3600 // LSYNC
    for kname, ref in (("ohreaction", "flexpart_tpu/physics/ohchem.py:200"),
                       ("split", "flexpart_tpu/core/split.py:26")):
        r = ohk[kname]
        n_launch = ohres["launches"][kname]
        line.append(
            {"name": kname, "route": "cuda", "source": src.format(kname),
             "replaces": ref, "tpu_route": "XLA", "launches": n_launch,
             "launches_per_step_sim_oh_split": n_launch / nsteps_oh,
             **{f: r[f] for f in pick},
             **{f: r[f] for f in ("n", "bitwise", "cases", "bound_bytes",
                                  "bound_operations", "unordered_ms",
                                  "layout", "oh_grid", "ms_with_host",
                                  "bound_sectors_ms",
                                  "edge_cases_due_free_granted",
                                  "edge_cases_s") if f in r},
             "sim_oh_split_held": ohres["run_b"]["held"][kname]})
    # K14-K17: the kernels_domainfill phase's numbers, the launches of the
    # path that runs each; the nest's sampling is K3's stock instantiation,
    # counted apart (conccalc.nest), with K3's numbers
    for kname, ref, path, pres in (
            ("domainfill", "flexpart_tpu/core/domainfill.py:319",
             "sim_domainfill", dfres),
            ("receptors", "flexpart_tpu/grid/receptors.py:52",
             "sim_domainfill", dfres),
            ("fluxes", "flexpart_tpu/grid/fluxes.py:46", "sim_domainfill",
             dfres),
            ("initcond", "flexpart_tpu/grid/initcond.py:49", "sim_initcond",
             icres)):
        r = dfk[kname]
        n_launch = pres["launches"][kname]
        line.append(
            {"name": kname, "route": "cuda", "source": src.format(kname),
             "replaces": ref, "tpu_route": "XLA", "launches": n_launch,
             f"launches_per_step_{path}": n_launch / pres["steps"],
             **{f: r[f] for f in pick},
             **{f: r[f] for f in ("n", "sites", "fill_s", "receptors",
                                  "receptors_seeing_mass", "pairs_inside",
                                  "bitwise", "cases", "bound_bytes",
                                  "bound_operations", "pairs", "cells_hit",
                                  "most_pairs_in_a_cell", "grid",
                                  "kernel_max_rel_err_vs_f64", "faces",
                                  "ms_with_host", "bound_sectors_ms",
                                  "per_launch", "bound_all_slots_ms",
                                  "bound_per_crossing_ms",
                                  "edge_cases_killed_free_wanted_granted",
                                  "edge_cases_sum", "edge_cases_pairs",
                                  "edge_cases_s")
                if f in r},
             f"{path}_per_call": pres["device_per_call"][kname],
             **{f: pres[f] for f in (
                 "initcond_bound_ms_per_call", "initcond_bound_last_call",
                 "initcond_masked_pairs_cells_per_call")
                if f in pres and kname == "initcond"},
             **({"sim_domainfill_bound_ms_per_call":
                 pres["domainfill_bound_ms_per_call"],
                 "sim_domainfill_bound_sectors_ms_per_call":
                 pres["domainfill_bound_sectors_ms_per_call"],
                 "sim_domainfill_memsets_per_call":
                 pres["device_per_call"]["domainfill_memsets"]}
                if kname == "domainfill" else {}),
             # K15 and K16 per call of sim_domainfill's counting run: the
             # bound by need, each call held against the plain version
             **({"sim_domainfill_bound_ms_per_call":
                 pres[f"{kname}_bound_ms_per_call"],
                 "sim_domainfill_held": pres[f"{kname}_held"]}
                if kname in ("receptors", "fluxes") else {}),
             **({f"sim_domainfill_per_call_{part}":
                 pres["device_per_call"][f"receptors_{part}"]
                 for part in ("partials", "reduce")}
                if kname == "receptors" else {})})
    line.append(
        {"name": "conccalc.nest", "route": "cuda",
         "source": src.format("conccalc"),
         # the nest's conccalc (run/simulation.py:1198-1203 there)
         "replaces": "flexpart_tpu/grid/conccalc.py:78", "tpu_route": "XLA",
         "launches": dfres["launches"]["conccalc.nest"],
         "launches_per_step_sim_domainfill":
             dfres["launches"]["conccalc.nest"] / dfres["steps"],
         "numbers_of": "conccalc: the stock instantiation, on the nest's grid",
         **{f: kres["conccalc"][f] for f in pick},
         "sim_domainfill_per_call_both_grids":
             dfres["device_per_call"]["conccalc_both_grids"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_script})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
