"""Port parity for the release schedule and the release mask flip.

``build_release_schedule`` is host numpy on both sides with
``np.random.default_rng(seed)``: every field of the port's particles must
equal the JAX package's bitwise, dtype included, with spare capacity and
several uncertainty classes, for a plain schedule (two boxes, two species)
and for one modulated by a species' hour-of-day factors.  ``activate`` is a
mask flip: bitwise over three release times, among particles that were
already terminated.  ``emission_time_factors`` is plain float64: equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu import config as jconfig  # noqa: E402
from flexpart_tpu import met as jmet  # noqa: E402
from flexpart_tpu.core import release as jrel  # noqa: E402
from flexpart_tpu_torch import config as tconfig  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import release as trel  # noqa: E402
from flexpart_tpu_torch.core.state import FIELDS, ITRA_INACTIVE  # noqa: E402
from flexpart_tpu_torch.met import make_grid  # noqa: E402

GRID = dict(nx=37, ny=15, nlev=15, dx=10.0, dy=10.0, ylat0=-70.0)
HOURS = tuple(0.25 + 0.125 * (h % 12) for h in range(24))


def _config(c, varying):
    cmd = c.Command(ibdate=20200101, ibtime=0, iedate=20200101, ietime=60000,
                    lsynctime=900, lconvection=0, lsubgrid=0, itsplit=7200)
    sp2 = c.Species(name="B", weightmolar=40.0,
                    **(dict(area_hour=HOURS, point_dow=(1.0,) * 5 + (0.5, 0.5))
                       if varying else {}))
    boxes = (c.ReleaseBox(idate1=20200101, itime1=0, idate2=20200101,
                          itime2=20000, lon1=0.0, lon2=2.0, lat1=40.0,
                          lat2=42.0, z1=50.0, z2=500.0, mass=(1.0, 3.0),
                          parts=1000),
             c.ReleaseBox(idate1=20200101, itime1=13000, idate2=20200101,
                          itime2=13000, lon1=-170.0, lon2=-170.0, lat1=-10.0,
                          lat2=-10.0, z1=1000.0, z2=1000.0, mass=(2.0,),
                          parts=333))
    return cmd, c.Releases(species=(c.Species(), sp2), boxes=boxes)


def _schedules(varying, capacity=1500):
    jcmd, jrels = _config(jconfig, varying)
    tcmd, trels = _config(tconfig, varying)
    jp = jrel.build_release_schedule(jrels, jcmd, jmet.make_grid(**GRID),
                                     capacity=capacity, nclassunc=3, seed=7)
    tp = trel.build_release_schedule(trels, tcmd, make_grid(**GRID),
                                     capacity=capacity, nclassunc=3, seed=7,
                                     device="cpu")
    return jp, tp


def _assert_bitwise(tp, jp, what=""):
    for f in FIELDS:
        a, b = interop.to_numpy(getattr(tp, f)), np.asarray(getattr(jp, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


@pytest.mark.parametrize("varying", [False, True])
def test_schedule_equals_jax_bitwise(varying):
    jp, tp = _schedules(varying)
    _assert_bitwise(tp, jp, f"time-varying={varying}")
    itra = tp.itra.numpy()
    n = int((itra != ITRA_INACTIVE).sum())
    assert (1000 < n <= 1500) if varying else n == 1333
    assert not bool(tp.active.any())
    assert len(set(itra[:n].tolist())) > 5         # spread over sync steps
    assert set(tp.nclass.tolist()) == {0, 1, 2}
    assert set(tp.npoint[:n].tolist()) == {0, 1}
    if varying:     # the factors do modulate the second species' masses
        assert len(set(tp.mass[:1000, 1].tolist())) > 1
        assert len(set(tp.mass[:1000, 0].tolist())) > 1


def test_schedule_refuses_what_is_not_ported():
    """A capacity below the scheduled particles is refused.  The backward
    deposition modes are ported: ``bkdep`` builds the JAX package's
    schedule (tests/test_torch_backward.py holds both modes)."""
    tcmd, trels = _config(tconfig, False)
    jcmd, jrels = _config(jconfig, False)
    jp = jrel.build_release_schedule(jrels, jcmd, jmet.make_grid(**GRID),
                                     bkdep=3)
    tp = trel.build_release_schedule(trels, tcmd, make_grid(**GRID), bkdep=3,
                                     device="cpu")
    _assert_bitwise(tp, jp, "bkdep=3")
    with pytest.raises(ValueError, match="capacity"):
        trel.build_release_schedule(trels, tcmd, make_grid(**GRID),
                                    capacity=10, device="cpu")


def test_activate_equals_jax_bitwise_over_three_release_times():
    jp, tp = _schedules(False)
    # some particles already ran and were terminated: they must stay off
    # unless their itra names this very step, as in the reference
    off = np.zeros(1500, bool)
    off[::7] = True
    up = np.random.default_rng(3).normal(size=1500).astype(np.float32)
    cbt = np.where(np.arange(1500) % 3 == 0, -1, 1).astype(np.int8)
    jp = jp._replace(up=jnp.asarray(up), vp=jnp.asarray(-up),
                     wp=jnp.asarray(2 * up), cbt=jnp.asarray(cbt))
    tp = tp.replace(up=torch.as_tensor(up), vp=torch.as_tensor(-up),
                    wp=torch.as_tensor(2 * up), cbt=torch.as_tensor(cbt))
    woken = 0
    for itime in (0, 900, 5400):       # the second box opens at 01:30:00
        jp = jrel.activate(jp, jnp.int32(itime))
        tp = trel.activate(tp, itime)
        _assert_bitwise(tp, jp, f"activate {itime}")
        assert tp.cbt.dtype == torch.int8
        now = int(tp.active.sum())
        assert now > woken
        woken = now
    assert bool((tp.up[tp.active] == 0).all())
    assert not bool(tp.active[tp.itra == ITRA_INACTIVE].any())


@pytest.mark.parametrize("itime", [0, 3600 * 5, 3600 * 33 + 900])
def test_emission_time_factors_equal_jax(itime):
    jcmd, jrels = _config(jconfig, True)
    tcmd, trels = _config(tconfig, True)
    for jb, tb in zip(jrels.boxes, trels.boxes):
        j = jrel.emission_time_factors(jrels, jb, jmet.make_grid(**GRID),
                                       jcmd.bdate, itime)
        t = trel.emission_time_factors(trels, tb, make_grid(**GRID),
                                       tcmd.bdate, itime)
        np.testing.assert_array_equal(t, j)
        assert t.shape == (2,) and t[0] == 1.0
    # the first box is an area source: the hour-of-day table applies
    first = trel.emission_time_factors(trels, trels.boxes[0],
                                       make_grid(**GRID), tcmd.bdate, itime)
    assert first[1] in set(HOURS) and first[1] != 1.0
