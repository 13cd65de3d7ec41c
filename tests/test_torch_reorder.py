"""The cell-order sort of the port (plain version of kernel K5).

``reorder_by_cell`` is a layout step that the JAX package does not have:
it permutes the particle slots so that particles of one met cell are
neighbours.  What must hold, all bitwise unless said:

  * the result is ``in[perm]`` for ``perm`` the stable argsort of the keys
    (every slot once, keys never decrease, equal keys keep their slot
    order), particles that are not scheduled come last, and a sorted
    ensemble is left as it is; this on the four inputs a run feeds the
    sort: a shuffled ensemble, a nearly ordered one, every slot
    unscheduled, and a release step;
  * the rank that kernel K5 computes (digit passes over tiles of pairs
    with per-warp counters, emulated here in numpy with K5's constants)
    is that stable argsort;
  * the key is the row of the quad tables that the advance gathers for
    the particle (``sample_all_quad``'s own row id);
  * the advance commutes with the permutation when the injected draws are
    permuted alike: ``advance(p[perm], d[:, perm]) == advance(p, d)[perm]``;
  * the sampled grid of the reordered ensemble equals the original's
    within rtol 1e-6 (only the order of the float additions into a cell
    changes), and equals the JAX ``conccalc`` of the unordered ensemble
    within the tolerance of ``tests/test_torch_conccalc.py`` (rtol 1e-6,
    atol 1e-12).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.config import OutGrid  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.grid import conccalc as jcc  # noqa: E402
from flexpart_tpu.grid import outgrid as jog  # noqa: E402
from flexpart_tpu_torch import _build, interop  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import interp as tinterp  # noqa: E402
from flexpart_tpu_torch.core import reorder  # noqa: E402
from flexpart_tpu_torch.core import rng as trng  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS  # noqa: E402
from flexpart_tpu_torch.grid import conccalc as tcc  # noqa: E402
from flexpart_tpu_torch.grid import outgrid as tog  # noqa: E402
from flexpart_tpu_torch.met.synthetic import make_grid  # noqa: E402

# a multiple of the widest CPU vector (16 floats, and 32 to spare): torch's
# pow rounds the elements of a last partial vector differently from the
# full ones, so at other sizes the plain advance is bitwise independent of
# a particle's position only by luck of the draws
N = 3008
MEM1 = 10800
ITIME = 3600
OG = OutGrid(outlon0=-60.0, outlat0=-30.0, numxgrid=48, numygrid=30,
             dxout=2.5, dyout=2.0, outheights=(300.0, 2000.0, 10000.0))
CONFIGS = {"stock": dict(turbswitch=False, ifine=1, met_bf16=True),
           "turb_ifine4": dict(turbswitch=True, ifine=4, met_bf16=False)}


@pytest.fixture(scope="module")
def setup():
    grid = jmet.make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    m = jmet.SyntheticMet(grid)
    zs = []
    for t in (0.0, float(MEM1)):
        eta = m.fetch(t)
        h = jmet.compute_heights(grid, eta)
        zs.append(jmet.calcpar(grid, eta, jmet.process_eta(grid, eta, h)))
    tz = [interop.zfields_from_numpy({k: np.asarray(v) for k, v in
                                      z._asdict().items()}, "cpu") for z in zs]
    return grid, zs, tz


def _jax_particles(grid, seed=5):
    """Particles over the whole grid, a tenth not scheduled, two species,
    half of them released at ITIME (fresh), every field distinct per slot
    so that a wrong gather shows."""
    rs = np.random.default_rng(seed)
    # x on a 2**-12 lattice: exact products on the output grid, as in
    # tests/test_torch_conccalc.py
    x = (np.round(rs.uniform(0.0, grid.nx - 1.0, N) * 4096) / 4096)
    y = (np.round(rs.uniform(0.3, grid.ny - 1.3, N) * 4096) / 4096)
    p = jstate.empty_particles(N, nspec=2)
    f32 = np.float32
    return p._replace(
        x_hi=jnp.asarray(x.astype(f32)), y_hi=jnp.asarray(y.astype(f32)),
        z=jnp.asarray(rs.uniform(5.0, 14000.0, N).astype(f32)),
        itra=jnp.full(N, ITIME, jnp.int32),
        itramem=jnp.asarray(np.where(rs.uniform(size=N) < 0.5, ITIME,
                                     ITIME - 14400).astype(np.int32)),
        npoint=jnp.zeros(N, jnp.int32),
        nclass=jnp.asarray(rs.integers(0, 2, N).astype(np.int32)),
        idt=jnp.asarray(rs.integers(1, 900, N).astype(np.int32)),
        itrasplit=jnp.asarray(rs.integers(0, 99999, N).astype(np.int32)),
        up=jnp.asarray(rs.normal(size=N).astype(f32)),
        vp=jnp.asarray(rs.normal(size=N).astype(f32)),
        wp=jnp.asarray(rs.normal(size=N).astype(f32)),
        usig=jnp.asarray(rs.normal(size=N).astype(f32) * 0.3),
        vsig=jnp.asarray(rs.normal(size=N).astype(f32) * 0.3),
        wsig=jnp.asarray(rs.normal(size=N).astype(f32) * 0.01),
        cbt=jnp.asarray(np.where(rs.uniform(size=N) < 0.2, -1, 1).astype(np.int8)),
        active=jnp.asarray(rs.uniform(size=N) < 0.9),
        mass=jnp.asarray(rs.uniform(0.5, 1.5, (N, 2)).astype(f32)),
        mass0=jnp.asarray(rs.uniform(0.5, 1.5, (N, 2)).astype(f32)),
        xscav=jnp.asarray(rs.uniform(0.0, 1.0, (N, 2)).astype(f32)))


def _port_particles(jp):
    return interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")


def _step_config(grid, **kw):
    return tadv.StepConfig(nx=grid.nx, ny=grid.ny, nz=grid.nlev, xglobal=True,
                           ldirect=1, method=0, **kw)


def _assert_same_bits(a, b, what=""):
    for f in FIELDS:
        np.testing.assert_array_equal(
            interop.to_numpy(getattr(a, f)), interop.to_numpy(getattr(b, f)),
            err_msg=f"{what} {f}")


def test_reorder_is_a_permutation_in_key_order(setup):
    grid, _, (t0, _) = setup
    cfg = _step_config(grid, **CONFIGS["stock"])
    p = _port_particles(_jax_particles(grid))
    q, perm = reorder.reorder_by_cell(p, t0.height, cfg)
    assert perm.dtype == torch.int32 and perm.shape == (N,)
    assert sorted(perm.tolist()) == list(range(N))
    # stable: equal keys keep their slot order, so perm is the one stable
    # argsort of the keys
    keys_in = reorder.cell_keys(p, t0.height, cfg).numpy()
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(keys_in, kind="stable"))
    _assert_same_bits(q, reorder.apply_perm(p, perm), "out != in[perm]")
    keys = reorder.cell_keys(q, t0.height, cfg)
    assert bool((keys[1:] >= keys[:-1]).all())
    n_on = int(p.active.sum())
    assert 0 < n_on < N
    assert bool(q.active[:n_on].all()) and not bool(q.active[n_on:].any())
    n_rows = (grid.nlev - 1) * grid.ny * grid.nx
    assert bool((keys[:n_on] < n_rows).all())
    assert bool((keys[n_on:] == n_rows).all())
    # many cells hold several particles and many particles change slot
    assert len(set(keys[:n_on].tolist())) < n_on
    assert int((perm != torch.arange(N, dtype=torch.int32)).sum()) > N // 2


def test_reorder_leaves_an_ordered_ensemble_alone(setup):
    grid, _, (t0, _) = setup
    cfg = _step_config(grid, **CONFIGS["stock"])
    p = _port_particles(_jax_particles(grid))
    q, _ = reorder.reorder_by_cell(p, t0.height, cfg)
    q2, perm2 = reorder.reorder_by_cell(q, t0.height, cfg)
    assert perm2.tolist() == list(range(N))
    _assert_same_bits(q2, q, "second sort")


def test_key_is_the_row_the_advance_gathers(setup):
    """The sort key of a scheduled particle is the row id that
    ``sample_all_quad`` and ``interp_wind_short_quad`` gather."""
    grid, _, (t0, _) = setup
    cfg = _step_config(grid, **CONFIGS["stock"])
    p = _port_particles(_jax_particles(grid))
    hw = tinterp.horiz_weights(p.x, p.y, cfg.nx, cfg.ny, cfg.xglobal)
    indz, _ = tinterp.vert_weights(p.z, t0.height)
    row = tinterp._cell_rowid(hw, indz, cfg.nx, cfg.ny)
    keys = reorder.cell_keys(p, t0.height, cfg)
    on = p.active
    assert torch.equal(keys[on], row[on])
    assert int(keys[on].min()) >= 0
    assert int(keys.max()) == (cfg.nz - 1) * cfg.ny * cfg.nx


@pytest.mark.parametrize("name", list(CONFIGS))
def test_advance_commutes_with_the_permutation(setup, name):
    grid, _, (t0, t1) = setup
    kw = CONFIGS[name]
    cfg = _step_config(grid, **kw)
    prm = tadv.StepParams.make(dx=grid.dx, dy=grid.dy, ylat0=grid.ylat0,
                               dxconst=grid.dxconst, dyconst=grid.dyconst,
                               lsynctime=900, fine=1.0 / kw["ifine"])
    p = _port_particles(_jax_particles(grid))
    q, perm = reorder.reorder_by_cell(p, t0.height, cfg)
    key = trng.Key(8, 1)
    rows = {**tadv.DRAW_ROWS, 2: kw["ifine"]}
    draws = {t: trng.normals(key, (r, N), t, device="cpu")
             for t, r in rows.items()}
    idx = perm.long()
    draws_q = {t: d[:, idx].contiguous() for t, d in draws.items()}
    tw = tadv._time_weights(ITIME, 0, MEM1, prm, cfg)[:4]
    tables = tinterp.build_step_tables_quad(t0, t1, *tw, dtype=cfg.table_dtype)
    a = tadv.advance_args(cfg, prm, ITIME, 0, MEM1)
    out_p, dp = tadv.advance_all_plain(p, t0.height, tables, a, key, cfg,
                                       draws, 0)
    out_q, dq = tadv.advance_all_plain(q, t0.height, tables, a, key, cfg,
                                       draws_q, 0)
    _assert_same_bits(out_q, reorder.apply_perm(out_p, perm), name)
    assert int(dp.n_active) == int(dq.n_active) > 0
    assert int(dp.n_exited) == int(dq.n_exited)
    # the step did move the particles, fresh and old
    assert not torch.equal(out_p.z, p.z)


@pytest.mark.parametrize("old", [False, True])
def test_conccalc_of_the_reordered_ensemble(setup, old):
    grid, (jz, _), (tz, _) = setup
    tgrid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    jgeo = jog.OutputGridGeometry(OG, grid)
    tgeo = tog.OutputGridGeometry(OG, tgrid)
    kw = dict(nxg=jgeo.nxg, nyg=jgeo.nyg, nzg=jgeo.nzg, npointspec=1,
              nclassunc=2, nage=2, dxout=OG.dxout, dyout=OG.dyout,
              xoutshift=jgeo.xoutshift, youtshift=jgeo.youtshift,
              dx_met=grid.dx, dy_met=grid.dy, ind_samp=0, kernel_possible=old)
    lage = np.asarray([7200, 999999], np.int32)
    jp = _jax_particles(grid)
    p = _port_particles(jp)
    cfg = _step_config(grid, **CONFIGS["stock"])
    q, _ = reorder.reorder_by_cell(p, tz.height, cfg)

    def sample(particles):
        acc = tog.zero_accumulators(tgeo, 2, 1, 2, 2, device="cpu")
        acc = tcc.make_conccalc(OG.outheights)(
            acc, particles, tz, ITIME, torch.as_tensor(lage), 0.5,
            tcc.ConcConfig(**kw))
        return acc.gridunc.numpy()

    g_p, g_q = sample(p), sample(q)
    assert g_p.sum() > 0.0
    np.testing.assert_allclose(g_q, g_p, rtol=1e-6, atol=1e-12)
    jacc = jog.zero_accumulators(jgeo, 2, 1, 2, 2)
    jacc = jcc.make_conccalc(OG.outheights)(
        jacc, jp, jz, jnp.int32(ITIME), jnp.asarray(lage), jnp.float32(0.5),
        jcc.ConcConfig(**kw))
    np.testing.assert_allclose(g_q, np.asarray(jacc.gridunc), rtol=1e-6,
                               atol=1e-12)


def test_unknown_device_raises(setup):
    grid, _, (t0, _) = setup
    cfg = _step_config(grid, **CONFIGS["stock"])
    p = _port_particles(_jax_particles(grid))
    meta = type(p)(**{f: getattr(p, f).to("meta") for f in FIELDS})
    with pytest.raises(ValueError, match="device"):
        reorder.reorder_by_cell(meta, t0.height, cfg)


def test_cuda_particles_never_take_the_plain_version(setup, monkeypatch):
    """Dispatch is by device type alone: ``cuda`` goes to the kernel
    launcher, never to ``reorder_by_cell_plain``."""
    grid, _, (t0, _) = setup
    cfg = _step_config(grid, **CONFIGS["stock"])
    p = _port_particles(_jax_particles(grid))
    calls = []

    class FakeCuda:
        type = "cuda"

    monkeypatch.setattr(type(p), "device", property(lambda self: FakeCuda()))
    monkeypatch.setattr(reorder, "reorder_by_cell_plain",
                        lambda *a: calls.append("plain"))
    monkeypatch.setattr(reorder, "reorder_by_cell_cuda",
                        lambda *a: calls.append("cuda") or (None, None))
    reorder.reorder_by_cell(p, t0.height, cfg)
    assert calls == ["cuda"]


def _four_inputs(grid, t0, cfg):
    """The inputs of the card's check at a small size."""
    p = _port_particles(_jax_particles(grid))
    ordered, _ = reorder.reorder_by_cell(p, t0.height, cfg)
    # nearly ordered: some particles moved on by a cell or a layer
    rs = np.random.default_rng(11)
    ordered = ordered.replace(
        x_hi=ordered.x_hi + torch.as_tensor(
            (rs.uniform(size=N) < 0.2) * 0.75, dtype=torch.float32),
        z=ordered.z * torch.as_tensor(
            1.0 + 0.3 * (rs.uniform(size=N) < 0.1), dtype=torch.float32))
    nobody = p.replace(active=torch.zeros_like(p.active))
    fresh = torch.zeros_like(p.active)
    fresh[-N // 8:] = True
    release = p.replace(
        active=fresh,
        x_hi=torch.where(fresh, 18.0 + 0.2 * (p.x_hi / grid.nx), p.x_hi),
        y_hi=torch.where(fresh, 11.0 + 0.2 * (p.y_hi / grid.ny), p.y_hi),
        z=torch.where(fresh, 50.0 + p.z / 30.0, p.z))
    return {"shuffled": p, "ordered": ordered, "all_unscheduled": nobody,
            "release_step": release}


def _cu_const(name):
    """A ``constexpr int`` of csrc/reorder.cu given as a number."""
    text = (_build.CSRC / "reorder.cu").read_text()
    return int(re.search(r"constexpr\s+int\s+%s\s*=\s*(\d+)\s*;" % name,
                         text).group(1))


# K5's tiling, from its source: pairs per warp and per block of a pass
MAX_DIGIT_BITS = _cu_const("MAX_DIGIT_BITS")
WARP_ITEMS = 32 * _cu_const("ROUNDS")
SORT_TILE = _cu_const("THREADS") // 32 * WARP_ITEMS


def _radix_plan(n_rows):
    """``radix_plan`` of csrc/reorder.cu: (passes, digit_bits), the fewest
    passes of at most ``MAX_DIGIT_BITS`` bits that cover the largest key,
    ``n_rows``, with the bits spread evenly over them."""
    bits = 1
    while n_rows >> bits:
        bits += 1
    passes = (bits + MAX_DIGIT_BITS - 1) // MAX_DIGIT_BITS
    return passes, (bits + passes - 1) // passes


def _radix_perm(keys, n_rows, tile=SORT_TILE, warp_items=WARP_ITEMS):
    """K5's rank in numpy: ``_radix_plan`` passes; in each a block owns
    ``tile`` consecutive pairs and each of its warps ``warp_items``, read
    32 at a time; the place of a pair is the scanned [digit][block] count
    plus the pairs of its digit in earlier warps of the block, in earlier
    rounds of its warp and in lower lanes of its round."""
    passes, bits = _radix_plan(n_rows)
    radix = 1 << bits
    n = len(keys)
    keys = np.asarray(keys, np.int64)
    slots = np.arange(n)
    n_blocks = -(-n // tile)
    for p in range(passes):
        digit = (keys >> (p * bits)) & (radix - 1)
        counts = np.zeros((radix, n_blocks), np.int64)
        for b in range(n_blocks):
            counts[:, b] = np.bincount(digit[b * tile:(b + 1) * tile],
                                       minlength=radix)
        flat = counts.reshape(-1)
        offsets = (np.cumsum(flat) - flat).reshape(radix, n_blocks)
        place = np.empty(n, np.int64)
        for b in range(n_blocks):
            nxt = offsets[:, b].copy()      # next free place per digit
            for w0 in range(b * tile, min((b + 1) * tile, n), warp_items):
                for r0 in range(w0, min(w0 + warp_items, n), 32):
                    d = digit[r0:r0 + 32]
                    for lane, dl in enumerate(d):
                        place[r0 + lane] = nxt[dl] + int((d[:lane] == dl).sum())
                    np.add.at(nxt, d, 1)
        out_k, out_s = np.empty_like(keys), np.empty_like(slots)
        out_k[place], out_s[place] = keys, slots
        keys, slots = out_k, out_s
    return slots


@pytest.mark.parametrize("name", ["shuffled", "ordered", "all_unscheduled",
                                  "release_step"])
def test_plain_sort_is_stable_on_what_a_run_feeds_it(setup, name):
    grid, _, (t0, _) = setup
    cfg = _step_config(grid, **CONFIGS["stock"])
    p = _four_inputs(grid, t0, cfg)[name]
    keys = reorder.cell_keys(p, t0.height, cfg).numpy()
    q, perm = reorder.reorder_by_cell_plain(p, t0.height, cfg)
    want = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), want)
    _assert_same_bits(q, reorder.apply_perm(p, torch.as_tensor(want)), name)
    sorted_keys = keys[want]
    same = sorted_keys[1:] == sorted_keys[:-1]
    assert same.any()        # there are equal keys to keep in order ...
    assert (np.diff(want)[same] > 0).all()      # ... and they are
    n_on = int(p.active.sum())
    assert not bool(q.active[n_on:].any())
    expect_bins = {"all_unscheduled": 1}.get(name)
    if expect_bins:
        assert len(set(keys.tolist())) == expect_bins
    if name == "release_step":
        assert len(set(keys.tolist())) < 20 and n_on == N // 8


@pytest.mark.parametrize("name", ["shuffled", "ordered", "all_unscheduled",
                                  "release_step"])
@pytest.mark.parametrize("tile,warp_items", [(SORT_TILE, WARP_ITEMS),
                                             (256, 64)])
def test_radix_rank_emulation_is_the_stable_argsort(setup, name, tile,
                                                    warp_items):
    """K5's tiling, and a smaller one that gives this ensemble a dozen
    blocks of four warps so that every term of the rank is exercised."""
    grid, _, (t0, _) = setup
    cfg = _step_config(grid, **CONFIGS["stock"])
    p = _four_inputs(grid, t0, cfg)[name]
    keys = reorder.cell_keys(p, t0.height, cfg).numpy()
    n_rows = (cfg.nz - 1) * cfg.ny * cfg.nx
    got = _radix_perm(keys, n_rows, tile, warp_items)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("n_rows,plan", [
    (1, (1, 1)), (255, (1, 8)), (256, (2, 5)), (9842, (2, 7)),
    (1894890, (3, 7)), (2 ** 24 - 1, (3, 8)), (2 ** 24, (4, 7)),
    (2 ** 28, (4, 8)), (2 ** 31 - 2, (4, 8))])
def test_radix_plan_covers_the_largest_key(n_rows, plan):
    """Every int32 key is covered, no pass is spared, the last shift stays
    inside an int32 key, and the wrapper's scratch holds the widest digit's
    counts (the kernel takes the lengths and refuses shorter ones)."""
    passes, bits = _radix_plan(n_rows)
    assert (passes, bits) == plan
    assert bits <= MAX_DIGIT_BITS and n_rows >> (passes * bits) == 0
    assert passes == 1 or n_rows >> ((passes - 1) * MAX_DIGIT_BITS)
    assert (passes - 1) * bits < 31
    assert (MAX_DIGIT_BITS, SORT_TILE) == (reorder.MAX_DIGIT_BITS,
                                           reorder.SORT_TILE)
