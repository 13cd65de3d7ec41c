"""Port parity: met preprocessing (process_eta + calcpar) against JAX.

The same numpy met goes through ``flexpart_tpu.met`` (XLA on the CPU)
and ``flexpart_tpu_torch.met`` (torch on the CPU).  Tolerance: rtol 1e-5
on every field — both sides do the same float32 arithmetic, but their
log/exp/pow implementations differ by an ulp or two, and the cumulative
height integral carries those ulps up the column.  The per-column
Richardson level must be identical: a flip there would move hmix by a
whole layer, which no tolerance may absorb.

``calcpv`` (potential vorticity on the eta levels) on a global grid with
both polar caps and on a regional one: within 1e-4 of each grid's largest
|PV| (theta's ``pow``, the neighbour interpolation on the isentrope and
the zonal mean of the cap rows round differently; measured 2.3e-5 and
1.0e-5).  ``calcpar(lsubgrid=True)`` adds the excess orography, capped by
``hmixplus``, to the mixing height: the other fields within rtol 1e-5,
``hmix`` within 5e-5 (``hmixplus`` is a wind speed over the root of a
Brunt-Vaisala frequency from a small temperature difference, and it is
added where it is below the 50 m of excess orography; measured 1.5e-5).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu_torch.met import calcpar as tcalcpar  # noqa: E402
from flexpart_tpu_torch.met import fields as tf  # noqa: E402
from flexpart_tpu_torch.met.synthetic import (SyntheticMet, make_grid,  # noqa: E402
                                              uniform_wind_met)
from flexpart_tpu_torch.met.verttransform import (compute_heights,  # noqa: E402
                                                  process_eta)

RTOL = 1e-5
F3 = {"U": tf.F3_U, "V": tf.F3_V, "W": tf.F3_W, "RHO": tf.F3_RHO,
      "DRHODZ": tf.F3_DRHODZ, "TT": tf.F3_TT, "QV": tf.F3_QV}
F2 = {"HMIX": tf.F2_HMIX, "TROPO": tf.F2_TROPO, "USTAR": tf.F2_USTAR,
      "WSTAR": tf.F2_WSTAR, "OLI": tf.F2_OLI}


@functools.cache
def _both(kind):
    """JAX and port met preprocessing of one backend (computed once)."""
    if kind == "synthetic":
        kw = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    else:
        kw = dict(nx=73, ny=37, nlev=30, dx=5.0, dy=5.0)
    jgrid = jmet.make_grid(**kw)
    tgrid = make_grid(**kw)
    if kind == "synthetic":
        jm, tm = jmet.SyntheticMet(jgrid), SyntheticMet(tgrid)
    else:
        jm, tm = (jmet.uniform_wind_met(jgrid, u=10.0, v=1.0),
                  uniform_wind_met(tgrid, u=10.0, v=1.0))
    jeta = jm.fetch(3600.0)
    teta = tm.fetch(3600.0, "cpu")
    jh = jmet.compute_heights(jgrid, jeta)
    th = compute_heights(tgrid, teta)
    jz = jmet.calcpar(jgrid, jeta, jmet.process_eta(jgrid, jeta, jh))
    tz = tcalcpar.calcpar(tgrid, teta, process_eta(tgrid, teta, th))
    return jgrid, jeta, jh, th, jz, tz


@pytest.mark.parametrize("kind", ["synthetic", "uniform"])
def test_met_matches_jax(kind):
    _, _, jh, th, jz, tz = _both(kind)
    np.testing.assert_allclose(th, jh, rtol=1e-12)
    f3j, f3t = np.asarray(jz.f3d), tz.f3d.numpy()
    f2j, f2t = np.asarray(jz.f2d), tz.f2d.numpy()
    report = {}
    for name, k in F3.items():
        a, b = f3t[k], f3j[k]
        report[name] = float(np.max(np.abs(a - b)))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6 * np.abs(b).max()
                                   + 1e-30, err_msg=f"f3d {name}")
    for name, k in F2.items():
        a, b = f2t[k], f2j[k]
        report[name] = float(np.max(np.abs(a - b)))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-30,
                                   err_msg=f"f2d {name}")
    np.testing.assert_array_equal(tz.clouds.numpy(), np.asarray(jz.clouds))
    print(kind, "max |port - jax|:", report)


def test_richardson_level_identical():
    """The critical Richardson level k of every column is the same."""
    jgrid, jeta, _, _, _, _ = _both("synthetic")
    import importlib

    import jax
    import jax.numpy as jnp
    jcp = importlib.import_module("flexpart_tpu.met.calcpar")
    akz = np.asarray(jgrid.akz, np.float32)
    bkz = np.asarray(jgrid.bkz, np.float32)
    e = {k: np.array(getattr(jeta, k)) for k in tf.ETA_FIELDS}
    ust_j = jcp.ustar_from_stress(*(jnp.asarray(e[k]) for k in
                                    ("ps", "tt2", "td2", "surfstr")))
    h_j, _, _ = jax.jit(jcp.richardson_hmix)(
        jnp.asarray(akz), jnp.asarray(bkz), jnp.asarray(e["ps"]), ust_j,
        *(jnp.asarray(e[k]) for k in ("tth", "qvh", "uuh", "vvh", "sshf",
                                      "tt2", "td2")))
    t = {k: torch.as_tensor(v) for k, v in e.items()}
    ust_t = tcalcpar.ustar_from_stress(t["ps"], t["tt2"], t["td2"],
                                       t["surfstr"])
    h_t, _, _ = tcalcpar.richardson_hmix(
        torch.as_tensor(akz), torch.as_tensor(bkz), t["ps"], ust_t, t["tth"],
        t["qvh"], t["uuh"], t["vvh"], t["sshf"], t["tt2"], t["td2"])
    # a level flip moves h by >= 1/20 of a layer (tens of metres)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=RTOL)


@pytest.mark.parametrize("kind", ["global", "regional"])
def test_calcpv_matches_jax(kind):
    from flexpart_tpu.met.calcpv import calcpv as jcalcpv
    from flexpart_tpu_torch.met.calcpv import calcpv
    if kind == "global":
        kw = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    else:
        kw = dict(nx=30, ny=20, nlev=12, dx=2.0, dy=2.0, xlon0=-20.0,
                  ylat0=20.0)
    jgrid, tgrid = jmet.make_grid(**kw), make_grid(**kw)
    assert (tgrid.xglobal, tgrid.nglobal, tgrid.sglobal) == (
        jgrid.xglobal, jgrid.nglobal, jgrid.sglobal) == ((kind == "global",)
                                                         * 3)
    jeta = jmet.SyntheticMet(jgrid).fetch(3600.0)
    teta = SyntheticMet(tgrid).fetch(3600.0, "cpu")
    a, b = calcpv(tgrid, teta).numpy(), np.asarray(jcalcpv(jgrid, jeta))
    assert a.shape == b.shape == (kw["nlev"], kw["ny"], kw["nx"])
    assert a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    if kind == "global":
        # the cap rows hold the zonal mean of the row next to them
        for cap, nb in ((0, 1), (-1, -2)):
            np.testing.assert_allclose(a[:, cap, :], a[:, nb, :].mean(
                axis=-1, keepdims=True).repeat(kw["nx"], -1), rtol=1e-6)


def test_process_eta_takes_calcpv():
    """The port's Simulation hands ``calcpv``'s field to ``process_eta``:
    ``F3_PV`` is that field on the height grid, not zero."""
    from flexpart_tpu_torch.met.calcpv import calcpv
    jgrid, jeta, jh, th, jz, _ = _both("synthetic")
    tgrid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    teta = SyntheticMet(tgrid).fetch(3600.0, "cpu")
    from flexpart_tpu.met.calcpv import calcpv as jcalcpv
    jz_pv = jmet.process_eta(jgrid, jeta, jh, pvh=jcalcpv(jgrid, jeta))
    tz_pv = process_eta(tgrid, teta, th, pvh=calcpv(tgrid, teta))
    a, b = tz_pv.f3d[tf.F3_PV].numpy(), np.asarray(jz_pv.f3d)[tf.F3_PV]
    assert np.abs(a).max() > 0.0
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_calcpar_lsubgrid_matches_jax():
    jgrid, jeta, jh, th, _, _ = _both("synthetic")
    tgrid = make_grid(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
    teta = SyntheticMet(tgrid).fetch(3600.0, "cpu")
    jz = jmet.calcpar(jgrid, jeta, jmet.process_eta(jgrid, jeta, jh),
                      lsubgrid=True)
    tz = tcalcpar.calcpar(tgrid, teta, process_eta(tgrid, teta, th),
                          lsubgrid=True)
    tz0 = tcalcpar.calcpar(tgrid, teta, process_eta(tgrid, teta, th))
    f2j, f2t = np.asarray(jz.f2d), tz.f2d.numpy()
    for name, k in F2.items():
        np.testing.assert_allclose(f2t[k], f2j[k],
                                   rtol=5e-5 if name == "HMIX" else RTOL,
                                   atol=1e-30, err_msg=f"f2d {name}")
    # SyntheticMet's excess orography is 50 m: hmix rises where the cap
    # allows it
    lift = f2t[tf.F2_HMIX] - tz0.f2d[tf.F2_HMIX].numpy()
    assert lift.max() > 0.0 and lift.min() >= 0.0 and lift.max() <= 50.0 + 1e-3
