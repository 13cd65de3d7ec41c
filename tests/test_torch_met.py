"""Port parity: met preprocessing (process_eta + calcpar) against JAX.

The same numpy met goes through ``flexpart_tpu.met`` (XLA on the CPU)
and ``flexpart_tpu_torch.met`` (torch on the CPU).  Tolerance: rtol 1e-5
on every field — both sides do the same float32 arithmetic, but their
log/exp/pow implementations differ by an ulp or two, and the cumulative
height integral carries those ulps up the column.  The per-column
Richardson level must be identical: a flip there would move hmix by a
whole layer, which no tolerance may absorb.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

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
