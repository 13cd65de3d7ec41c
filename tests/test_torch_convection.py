"""Port parity: Emanuel convection and the particle redistribution
(``flexpart_tpu_torch/physics/convection.py``, the plain versions of K6
and K7) against ``flexpart_tpu/physics/convection.py``.

The same numpy inputs go through both packages on the CPU:
  * the two soundings of ``tests/test_convection.py`` (moist-unstable
    tropical, stable isothermal) through five steps of the cloud-base mass
    flux spin-up;
  * SyntheticMet's columns of the 37x19x15 grid, two met times, through
    the whole convection step (profiles, scheme, matrix, heights) for three
    steps;
  * particles in the convecting columns through the redistribution, with
    JAX's own uniform draws injected, forward and backward (the transposed
    matrix).

Tolerances.  Both sides run the same float32 operations, but JAX's
``cumsum`` on the CPU is an associative scan and XLA contracts
``a*b + c*d``, while the port adds every level sum in level order (so that
K6 and K7 equal it bitwise on the card): the matrix agrees within 1e-4 of
its largest value (measured: 3.3e-5 for ``fmass`` on the soundings, 1.4e-6
for ``fmassfrac`` on SyntheticMet); the subsidence and the flux memory,
each a small difference of larger sums, within 5e-4 of their largest
value (measured 1.5e-4 on SyntheticMet); the profiles and the heights
within rtol 1e-5; the discrete outputs (``lconv``, ``nctop``) exactly.  A
level choice is discrete: one ulp in the cumulative row can move a
particle to the next level, so the
redistribution is held as a count of particles whose level differs (at
most 1%, measured 0), z within 1e-2 m + rtol 1e-4 for the rest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core.state import empty_particles as jempty  # noqa: E402
from flexpart_tpu.met.grid import hybrid_coefficients  # noqa: E402
from flexpart_tpu.met.thermo import f_qvsat as jf_qvsat  # noqa: E402
from flexpart_tpu.physics import convection as jconv  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import rng  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.met.synthetic import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.physics import convection as tconv  # noqa: E402

NL = 25
GRID = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
ETA = ("ps", "tth", "qvh", "tt2", "td2")


def _soundings(nl):
    """Two columns: (0) moist-unstable tropical, (1) stable isothermal
    (``tests/test_convection.py::_soundings``), as float32 numpy."""
    L2 = nl + 2
    akm, bkm = hybrid_coefficients(L2 + 2)
    ps = 101325.0
    ph = (akm + bkm * ps)[1:L2 + 1] / 100.0
    ph = np.sort(ph)[::-1].copy()
    ph[0] = ps / 100.0
    p = 0.5 * (ph[:-1] + ph[1:])
    z = -7500.0 * np.log(p / (ps / 100.0))
    t_unst = np.maximum(300.0 - 6.5e-3 * z, 200.0)
    qsat = np.asarray(jf_qvsat(jnp.asarray(p * 100.0), jnp.asarray(t_unst)))
    q_unst = 0.92 * qsat * np.exp(-z / 3000.0)
    t_stab = np.full_like(z, 280.0) + 2e-3 * z
    q_stab = 1e-4 * np.exp(-z / 8000.0)
    return [np.stack(a).astype(np.float32) for a in
            ([p, p], [ph, ph], [t_unst, t_stab], [q_unst, q_stab])]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def soundings():
    """Five spin-up steps of both packages on the two soundings."""
    pc, phc, tc, qc = _soundings(NL)
    cb_j, cb_t = jnp.zeros(2, jnp.float32), torch.zeros(2)
    steps = []
    for _ in range(5):
        j = jconv.convect_columns(*(jnp.asarray(a) for a in (pc, phc, tc,
                                                             qc)), cb_j, NL)
        t = tconv.convect_columns(*(_t(a) for a in (pc, phc, tc, qc)), cb_t,
                                  NL)
        steps.append((j, t))
        cb_j, cb_t = j[2], t[2]
    return (pc, phc, tc, qc), steps


def _close_to_max(a, b, share, what):
    """|a - b| within ``share`` of b's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=share * max(np.abs(b).max(), 1e-30),
                               err_msg=what)


def test_soundings_match_jax_through_the_spin_up(soundings):
    """fmass, sub, cbmf, lconv and nctop of every spin-up step."""
    _, steps = soundings
    for k, ((fj, sj, cj, lj, nj), (ft, st, ct, lt, nt)) in enumerate(steps):
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        assert nt.dtype == torch.int32 and lt.dtype == torch.bool
        _close_to_max(ft.numpy(), fj, 1e-4, f"fmass step {k}")
        _close_to_max(st.numpy(), sj, 5e-4, f"sub step {k}")
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                                   atol=1e-12, err_msg=f"cbmf step {k}")
    # the flux memory did spin up, and only in the unstable column
    assert 0.0 < float(steps[0][1][2][0]) < float(steps[-1][1][2][0])
    assert float(steps[-1][1][2][1]) == 0.0


def test_fmassfrac_and_uvzlev_match_jax(soundings):
    (pc, phc, tc, qc), steps = soundings
    (fj, sj, *_), (ft, st, *_) = steps[-1]
    dpr = (phc[:, :-1] - phc[:, 1:]) * 100.0
    frj, rlj = jconv.fmassfrac_from_fmass(fj, sj, jnp.asarray(dpr),
                                          jnp.float32(900.0), NL)
    frt, rlt = tconv.fmassfrac_from_fmass(ft, st, _t(dpr), 900.0, NL)
    _close_to_max(frt.numpy(), frj, 1e-5, "fmassfrac")
    np.testing.assert_allclose(rlt.numpy(), np.asarray(rlj), rtol=1e-6)
    tt2 = np.array([302.0, 280.0], np.float32)
    td2 = tt2 - 2.0
    ps = np.array([1013.25, 1013.25], np.float32)
    uj = jconv._uvzlev(*(jnp.asarray(a) for a in (phc, pc, tc, qc, tt2, td2,
                                                  ps)))
    ut = tconv._uvzlev(*(_t(a) for a in (phc, pc, tc, qc, tt2, td2, ps)))
    assert ut.shape == (2, NL + 2)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-5,
                               atol=1e-3)


def test_trigger_and_matrix_conservation(soundings):
    """``tests/test_convection.py::test_trigger_and_matrix_conservation``
    on the port."""
    (_, phc, _, _), steps = soundings
    fmass, sub, cbmf0, lconv, nctop = steps[-1][1]
    lconv = lconv.numpy()
    assert lconv[0], "unstable tropical sounding must convect"
    assert not lconv[1], "stable column must not convect"
    assert float(cbmf0[0]) > 0.0
    assert float(cbmf0[1]) == 0.0
    assert int(nctop[0]) > 2
    dpr = _t((phc[:, :-1] - phc[:, 1:]) * 100.0)
    fr, rl = tconv.fmassfrac_from_fmass(fmass, sub, dpr, 900.0, NL)
    fr, rl = fr.numpy(), rl.numpy()
    # every source level's row must redistribute exactly its level mass
    np.testing.assert_allclose(fr[0].sum(axis=1), rl[0], rtol=2e-4)
    off = fr[0] - np.diag(np.diag(fr[0]))
    assert off.min() >= -1e-6
    assert np.triu(fr[0], k=1).sum() > 0.0


def _sounding_fields(soundings):
    (pc, phc, tc, qc), steps = soundings
    fmass, sub, _, lconv, _ = steps[-1][1]
    dpr = _t((phc[:, :-1] - phc[:, 1:]) * 100.0)
    fr, rl = tconv.fmassfrac_from_fmass(fmass, sub, dpr, 900.0, NL)
    tt2 = torch.tensor([302.0, 280.0])
    uvz = tconv._uvzlev(_t(phc), _t(pc), _t(tc), _t(qc), tt2, tt2 - 2.0,
                        torch.tensor([1013.25, 1013.25]))
    return fr, rl, _t(phc), sub, uvz, _t(pc), _t(tc), lconv


def _near_surface(n, z=120.0):
    p = empty_particles(n, device="cpu")
    return p.replace(z=torch.full((n,), z),
                     active=torch.ones(n, dtype=torch.bool),
                     itra=torch.zeros(n, dtype=torch.int32))


def test_redist_moves_mass_upward(soundings):
    """``tests/test_convection.py::test_redist_moves_mass_upward`` on the
    port, with its own Philox uniforms: particles seeded near the surface
    of the convecting column are lifted on average."""
    n = 4096
    p2, n_moved = tconv.redist_particles(
        _near_surface(n), rng.Key(3, 0), *_sounding_fields(soundings), 900, 0,
        nl=NL, nx=1, ny=2)
    z2 = p2.z.numpy()
    assert int(n_moved) > 0, "no particles redistributed"
    assert n_moved.dtype == torch.int32
    assert np.all(np.isfinite(z2)) and np.all(z2 >= 0.0)
    assert z2.mean() > 120.0, "convection should loft near-surface particles"
    assert z2.max() > 3000.0


def test_own_uniforms_are_philox_word_zero(soundings):
    """Without injected draws the redistribution takes
    ``rng.uniforms_plain`` under ``REDIST_TAG``: word 0 of Philox(counter
    (slot, 0, 0, 0)), its top 24 bits, in [0, 1); the same with the draws
    injected, bitwise."""
    n = 4096
    key = rng.Key(3, 7)
    k0, k1 = key.philox_key(tconv.REDIST_TAG)
    u = rng.uniforms_plain(n, k0, k1, "cpu")
    w0 = rng.philox4x32_10(torch.arange(n, dtype=torch.int64),
                           *(torch.zeros(n, dtype=torch.int64),) * 3, k0,
                           k1)[0]
    assert torch.equal(u, (w0 >> 8).to(torch.float32) * 2.0 ** -24)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
    fields = _sounding_fields(soundings)
    a, ma = tconv.redist_particles(_near_surface(n), key, *fields, 900, 0,
                                   nl=NL, nx=1, ny=2)
    b, mb = tconv.redist_particles(_near_surface(n), key, *fields, 900, 0,
                                   nl=NL, nx=1, ny=2, rn=u)
    assert torch.equal(a.z, b.z) and int(ma) == int(mb) > 0


@pytest.fixture(scope="module")
def synthetic():
    """Three steps of the whole convection step of both packages on
    SyntheticMet's columns (two met times, weights 0.75 / 0.25)."""
    jg, tg = jmet.make_grid(**GRID), make_grid(**GRID)
    je = [jmet.SyntheticMet(jg).fetch(t) for t in (0.0, 3600.0)]
    te = [SyntheticMet(tg).fetch(t, "cpu") for t in (0.0, 3600.0)]
    jk, tk = jconv.make_convection_kernel(jg), tconv.make_convection_kernel(tg)
    assert jk.nl == tk.nl == tconv.nconvlev_from_grid(tg.akz, tg.bkz, 15)
    C = tg.nx * tg.ny
    cb_j, cb_t = jnp.zeros(C, jnp.float32), torch.zeros(C)
    steps = []
    for _ in range(3):
        oj = jk(*(getattr(e, n) for e in je for n in ETA), jnp.float32(0.75),
                jnp.float32(0.25), cb_j, jnp.float32(900.0))
        ot = tk(*(getattr(e, n) for e in te for n in ETA), 0.75, 0.25, cb_t,
                900.0)
        steps.append((oj, ot))
        cb_j, cb_t = oj[-1], ot.cbmf
    return jg, tg, tk, steps


def test_synthetic_columns_match_jax(synthetic):
    """Every output of the convection step: the matrix, the profiles, the
    heights, the flags and the flux memory, for each of three steps."""
    _, tg, tk, steps = synthetic
    C, L1 = tg.nx * tg.ny, tk.L1
    shapes = dict(fmassfrac=(C, L1, L1), rlevmass=(C, L1),
                  phconv=(C, L1 + 1), pconv=(C, L1), tconv=(C, L1),
                  sub=(C, L1), uvzlev=(C, L1 + 1), lconv=(C,), nctop=(C,),
                  cbmf=(C,))
    for k, (oj, ot) in enumerate(steps):
        assert int(ot.lconv.sum()) > 50          # the tropical band
        for name, j in zip(tconv.ConvectionFields._fields, oj):
            t = getattr(ot, name)
            assert tuple(t.shape) == shapes[name] and t.is_contiguous(), name
            if name in ("lconv", "nctop"):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                              err_msg=name)
            elif name in ("fmassfrac", "sub", "cbmf"):
                _close_to_max(t.numpy(), j,
                              1e-4 if name == "fmassfrac" else 5e-4,
                              f"{name} step {k}")
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"{name} step {k}")


def test_redist_with_jax_uniforms_matches_jax(synthetic):
    """Particles spread over the convecting columns at all heights, with
    JAX's uniform draws injected: the same particles move, to the same
    levels, and z agrees."""
    _redist_against_jax(synthetic, 1)


def test_redist_backward_with_jax_uniforms_matches_jax(synthetic):
    """A backward run (``ldirect=-1``) draws against the transposed matrix
    (``convection.py:479-480`` there): the same particles as the forward
    test, the same tolerances."""
    _redist_against_jax(synthetic, -1)


def _redist_against_jax(synthetic, ldirect):
    jg, tg, tk, steps = synthetic
    oj, _ = steps[-1]
    n = 4096
    rs = np.random.default_rng(11)
    jy, ix = np.nonzero(np.asarray(oj[7]).reshape(jg.ny, jg.nx))
    sel = rs.integers(0, len(jy), n)
    x = (ix[sel] + rs.uniform(-0.49, 0.49, n)).astype(np.float32)
    y = (jy[sel] + rs.uniform(-0.49, 0.49, n)).astype(np.float32)
    # near the ground, where the matrix lifts particles, and above it
    z = np.where(rs.uniform(size=n) < 0.5, rs.uniform(5.0, 400.0, n),
                 rs.uniform(5.0, 14000.0, n)).astype(np.float32)
    active = rs.uniform(size=n) < 0.97
    p = jempty(n)._replace(x_hi=jnp.asarray(x), y_hi=jnp.asarray(y),
                           z=jnp.asarray(z), active=jnp.asarray(active),
                           itra=jnp.zeros(n, jnp.int32))
    key = jax.random.fold_in(jax.random.PRNGKey(5), 1000000 + 3)
    fm, rl, ph, pc, tcv, sub, uvz, lconv, _, _ = oj
    pj, mj = jconv.redist_particles(
        p, key, fm, rl, ph, sub, uvz, pc, tcv, lconv, jnp.int32(900),
        jnp.int32(0), nl=tk.nl, nx=jg.nx, ny=jg.ny, ldirect=ldirect)
    rn = torch.as_tensor(np.array(jax.random.uniform(key, (n,))))
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in p._asdict().items()}, "cpu")
    f = [_t(a) for a in oj]
    pt, mt = tconv.redist_particles(
        tp, rng.Key(5, 3), f[0], f[1], f[2], f[5], f[6], f[3], f[4], f[7],
        900, 0, nl=tk.nl, nx=tg.nx, ny=tg.ny, rn=rn, ldirect=ldirect)
    assert int(mt) == int(mj) > 0
    zj, zt = np.asarray(pj.z), pt.z.numpy()
    # the level each particle ends in, on the JAX side's half-level heights
    col = (np.clip(np.round(y), 0, jg.ny - 1) * jg.nx
           + np.clip(np.round(x), 0, jg.nx - 1)).astype(int)
    u = np.asarray(uvz)[col]
    lev_j = (u[:, 1:] < zj[:, None]).sum(axis=1)
    lev_t = (u[:, 1:] < zt[:, None]).sum(axis=1)
    assert (lev_j != lev_t).sum() <= 0.01 * n
    same = lev_j == lev_t
    assert np.all(np.abs(zt - zj)[same] <= 1e-2 + 1e-4 * np.abs(zj)[same])
    # the draws did move particles, and not only by subsidence
    moved = np.abs(zj - z) > 200.0
    assert moved.sum() > 0
