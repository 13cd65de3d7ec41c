"""Port parity: the per-step mass updates of ``physics/massupdate.py``.

The same particles (numpy, one seed) go through
``flexpart_tpu.physics.massupdate`` and the port's plain versions:
``apply_wetdepo`` (the mass half of kernel K9), ``apply_decay_drydep``
(kernel K10's twin) with and without a deposition-velocity field, and
``decay_deposition_grids``.

Tolerances: mass rtol 1e-6, deposit rtol 1e-5 (atol 1e-30 for zeros),
``active`` equal.  Both sides compute the same float32 operations; XLA:CPU
may contract a product and a sum into an FMA and its ``exp`` is not
torch's, so the results agree to an ulp or two, not bitwise.  The
dry-deposition probability 1 - exp(-vd dt / 30 m) and the decay factors
carry those ulps into the deposit, whence its wider tolerance.

Covered: two species, one decaying (the deposit's decay correction over
``ldeltat``) and one not; particles that are inactive; a restmass at or
below the smallest normal float (set to 0); particles above and below
2 HREF; a particle that minmass terminates and one released with no mass
of a species (``mass0 == 0`` counts as kept).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu.physics import massupdate as jmu  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.physics import massupdate as tmu  # noqa: E402

N = 2048
NX, NY = 37, 19
SP = dict(decay=(0.693147 / 7200.0, -1.0), drydep=(True, True),
          minmass=1.0e-4)


def _particles(seed=0):
    rs = np.random.default_rng(seed)
    mass0 = rs.uniform(0.5, 1.5, (N, 2)).astype(np.float32)
    mass0[5, 1] = 0.0                         # released without species 1
    mass = (mass0 * rs.uniform(0.3, 1.0, (N, 2))).astype(np.float32)
    mass[7] = mass0[7] * 1.0e-5               # below minmass: terminated
    mass[5, 0] = mass0[5, 0] * 1.0e-5         # ... but kept by species 1
    mass[9, 0] = 1.0e-39                      # a subnormal mass
    p = jstate.empty_particles(N, nspec=2)
    return p._replace(
        x_hi=jnp.asarray(rs.uniform(-0.5, NX - 0.5, N).astype(np.float32)),
        y_hi=jnp.asarray(rs.uniform(-0.5, NY - 0.5, N).astype(np.float32)),
        z=jnp.asarray(rs.uniform(0.0, 60.0, N).astype(np.float32)),
        active=jnp.asarray(rs.uniform(size=N) < 0.9).at[7].set(True)
        .at[5].set(True),
        mass=jnp.asarray(mass), mass0=jnp.asarray(mass0))


def _port(p):
    return interop.particles_from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p._fields}, "cpu")


def _close(t, j, rtol, what):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=1e-30, err_msg=what)


def test_apply_wetdepo_matches_jax():
    rs = np.random.default_rng(1)
    p = _particles()
    lam = rs.uniform(0.0, 5e-4, (2, N)).astype(np.float32)
    lam[:, rs.uniform(size=N) < 0.3] = 0.0
    lam[0, 9] = 1.0                           # removes the subnormal mass
    lam[1, 11] = 50.0                         # removes everything
    grf = rs.uniform(0.05, 1.0, N).astype(np.float32)
    grf[11] = 1.0
    jsp = jmu.MassSpecies(**SP)
    tsp = tmu.MassSpecies(**SP)
    jp, jdep = jmu.apply_wetdepo(p, jnp.asarray(lam), jnp.asarray(grf),
                                 jnp.int32(900), jnp.int32(1800), jsp)
    tp, tdep = tmu.apply_wetdepo_plain(_port(p), torch.as_tensor(lam),
                                       torch.as_tensor(grf), 900, 1800, tsp)
    _close(tp.mass, jp.mass, 1e-6, "mass")
    _close(tdep, jdep, 1e-5, "deposit")
    assert tdep.shape == (2, N) and tdep.is_contiguous()
    assert float(tp.mass[11, 1]) == 0.0 and float(tp.mass[9, 0]) == 0.0
    assert float(tdep[:, ~tp.active].abs().sum()) == 0.0
    assert float(tdep.sum()) > 0.0


@pytest.mark.parametrize("has_vdep", [True, False])
def test_apply_decay_drydep_matches_jax(has_vdep):
    rs = np.random.default_rng(2)
    p = _particles()
    vdep = rs.uniform(0.0, 0.05, (2, NY, NX)).astype(np.float32)
    jsp = jmu.MassSpecies(**SP)
    tsp = tmu.MassSpecies(**SP)
    jp, jdep = jmu.apply_decay_drydep(
        p, jnp.asarray(vdep) if has_vdep else None, jnp.int32(900),
        jnp.int32(2700), jsp, has_vdep=has_vdep)
    tp, tdep = tmu.apply_decay_drydep(
        _port(p), torch.as_tensor(vdep) if has_vdep else None, 900, 2700,
        tsp, has_vdep=has_vdep)
    _close(tp.mass, jp.mass, 1e-6, "mass")
    _close(tdep, jdep, 1e-5, "deposit")
    np.testing.assert_array_equal(tp.active.numpy(), np.asarray(jp.active))
    assert not bool(tp.active[7]) and bool(tp.active[5])
    # inactive particles keep their mass and deposit nothing
    was = _port(p)
    off = ~was.active
    assert torch.equal(tp.mass[off], was.mass[off])
    assert float(tdep[:, off].abs().sum()) == 0.0
    if has_vdep:
        above = (was.z >= 30.0) & was.active
        assert float(tdep[1, above].abs().sum()) == 0.0    # no decay there
        assert float(tdep[:, ~above & was.active].sum()) > 0.0
    else:
        assert float(tdep.abs().sum()) == 0.0


def test_decay_deposition_grids_matches_jax():
    rs = np.random.default_rng(3)
    shape = (2, 1, 3, 8, 9, 2)
    wet = rs.uniform(0.0, 1.0, shape).astype(np.float32)
    dry = rs.uniform(0.0, 1.0, shape).astype(np.float32)
    decay = np.asarray(SP["decay"], np.float32)
    jw, jd = jmu.decay_deposition_grids(jnp.asarray(wet), jnp.asarray(dry),
                                        jnp.asarray(decay), jnp.int32(900))
    # copies: on the CPU jnp.asarray may alias the numpy buffer, and JAX's
    # asynchronous computation may read it after the port multiplied in
    # place
    tw, td = torch.tensor(wet), torch.tensor(dry)
    out = tmu.decay_deposition_grids(tw, td, torch.as_tensor(decay), 900)
    assert out[0] is tw and out[1] is td                     # in place
    _close(tw, jw, 1e-6, "wet")
    _close(td, jd, 1e-6, "dry")
    np.testing.assert_array_equal(td[..., 1].numpy(), dry[..., 1])


def test_unknown_device_raises():
    tp = _port(_particles())
    meta = type(tp)(**{f: getattr(tp, f).to("meta")
                       for f in tp.__dataclass_fields__})
    with pytest.raises(ValueError, match="backend"):
        tmu.apply_decay_drydep(meta, None, 900, 0, tmu.MassSpecies(**SP),
                               has_vdep=False)
