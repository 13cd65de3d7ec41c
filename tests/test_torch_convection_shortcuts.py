"""What K6's and K7's designs rely on, held on the plain versions.

K6 (``csrc/convection.cu``) writes the outputs of a column that does not
convect without running the scheme's O(L1^2) part, keeps no SIJ matrix
beside MENT, and finds the parcel origin by warp reductions; K7
(``csrc/redist.cu``) lets the lanes of a warp that share a column or a
matrix row share its loads and its cumulative sum.  Each is right only if
the plain pipeline, which the kernels must equal bit for bit on the card,
has the property below:

  * a column with ``lconv == False`` has exactly the fixed outputs of
    K6's early exit (``fmassfrac`` = diag(``rlevmass``) with ``+0`` off
    the diagonal, ``sub`` = 0, ``nctop`` = min(1, nl - 1)), and a column
    whose level masses are not finite gives NaN off the diagonal too
    (0 * NaN), which the early exit spells the same way;
  * MENT(i, j) is a function of the clamped SIJ(i, j): the level mixes iff
    0 < SIJ < 0.9 after the clamp, and then M / (1 - SIJ) is the same
    float before and after it;
  * the argmin / argmax over levels that K6 makes by a butterfly of
    (value, first index) pairs is ``torch.argmin`` / ``torch.argmax``;
  * ``redist_plain`` on permuted particles, with their uniforms permuted
    with them, gives the permuted result: no particle's result depends on
    its neighbours.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

from flexpart_tpu_torch.core import rng  # noqa: E402
from flexpart_tpu_torch.core.state import empty_particles  # noqa: E402
from flexpart_tpu_torch.met.synthetic import SyntheticMet, make_grid  # noqa: E402
from flexpart_tpu_torch.physics import convection as tconv  # noqa: E402

GRID = dict(nx=37, ny=19, nlev=15, dx=10.0, dy=10.0)
ETA = ("ps", "tth", "qvh", "tt2", "td2")
DELT = 900.0


def _bits(a):
    return a.contiguous().view(torch.int32)


@pytest.fixture(scope="module")
def synthetic():
    """Three steps of the plain convection step on SyntheticMet's columns
    (weights 0.75 / 0.25, the flux memory fed back), the grid's column 5
    given a NaN surface pressure in both met times."""
    grid = make_grid(**GRID)
    e = [SyntheticMet(grid).fetch(t, "cpu") for t in (0.0, 3600.0)]
    fields = [getattr(x, n).clone() for x in e for n in ETA]
    for k in (0, 5):                      # ps of both times
        fields[k].view(-1)[5] = float("nan")
    kern = tconv.make_convection_kernel(grid)
    cbmf = torch.zeros(grid.nx * grid.ny)
    steps = []
    for _ in range(3):
        out = tconv.convection_plain(kern, fields, 0.75, 0.25, cbmf, DELT)
        steps.append(out)
        cbmf = out.cbmf
    return grid, kern, steps


@pytest.mark.parametrize("step", [0, 1, 2])
def test_non_convecting_columns_have_the_early_exit_outputs(synthetic, step):
    grid, kern, steps = synthetic
    out = steps[step]
    L1, nl = kern.L1, kern.nl
    off = out.lconv.logical_not()
    assert 50 < int(out.lconv.sum()) < out.lconv.numel() - 50
    fm, rl = out.fmassfrac[off], out.rlevmass[off]
    eye = torch.eye(L1, dtype=torch.bool)[None]
    finite = torch.isfinite(rl).all(dim=1)
    # the finite columns: diag(rlevmass) bitwise, +0 elsewhere (bits 0)
    diag = torch.diagonal(fm, dim1=1, dim2=2)
    assert torch.equal(_bits(diag[finite]), _bits(rl[finite]))
    offd = fm[finite].masked_select(~eye)
    assert torch.equal(_bits(offd), torch.zeros_like(_bits(offd)))
    # the spelling of the early exit: delt * 0 + e * (dpr / g - rowsum)
    f0 = torch.tensor(DELT, dtype=torch.float32) * 0.0
    rowsum = f0
    for _ in range(L1 - 1):
        rowsum = rowsum + f0
    d = rl - rowsum
    want = torch.where(eye, f0 + 1.0 * d[:, :, None], f0 + 0.0 * d[:, :, None])
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(fm), nan)
    assert torch.equal(_bits(fm[~nan]), _bits(want[~nan]))
    assert torch.equal(_bits(out.sub[off]), torch.zeros_like(_bits(out.sub[off])))
    assert bool((out.nctop[off] == min(1, nl - 1)).all())
    assert bool((out.cbmf[off] >= 0.0).all())


def test_a_column_with_nan_level_masses(synthetic):
    """Column 5 (NaN surface pressure): it does not convect, its level
    masses are NaN below the pure-pressure levels, and with them every
    element of its fmassfrac row is NaN, off the diagonal too (0 * NaN);
    its subsidence is 0, its flux memory 0, nctop min(1, nl - 1)."""
    grid, kern, steps = synthetic
    for out in steps:
        assert not bool(out.lconv[5])
        rl = out.rlevmass[5]
        bad = ~torch.isfinite(rl)
        assert bool(bad.any())
        fm = out.fmassfrac[5]
        assert bool(torch.isnan(fm[bad]).all())
        assert float(out.sub[5].abs().max()) == 0.0
        assert float(out.cbmf[5]) == 0.0
        assert int(out.nctop[5]) == min(1, kern.nl - 1)


def test_ment_is_a_function_of_the_clamped_sij():
    """For j != i: ``0 < s < 0.9`` on the raw SIJ iff on the clamped one
    (``clamp(s, 0, 1) * (1 - 0) + 0``), and M / (1 - s) is bitwise the same
    for both where it holds; for j == i the clamped value is 1 (NaN for a
    NaN SIJ: the clamp takes an infinity to 0 or 1) and the level never
    mixes."""
    rs = np.random.default_rng(4)
    s = np.concatenate([
        rs.uniform(-2.0, 3.0, 20000), rs.uniform(0.0, 1.0, 20000),
        [0.0, -0.0, 0.9, np.nextafter(0.9, 0), np.nextafter(0.9, 1), 1.0,
         np.nextafter(0.0, 1), -np.nextafter(0.0, 1), np.inf, -np.inf,
         np.nan, 1e-38, 2.0]]).astype(np.float32)
    s = torch.as_tensor(s)
    m = torch.as_tensor(rs.uniform(0.0, 5.0, s.numel()).astype(np.float32))
    for eye in (0.0, 1.0):
        c = torch.clamp(s, 0.0, 1.0) * (1.0 - eye) + eye
        raw = (s > 0.0) & (s < 0.9) & (eye == 0.0)
        kept = (c > 0.0) & (c < 0.9) & (eye == 0.0)
        assert torch.equal(raw, kept)
        assert torch.equal(_bits(m[raw] / (1.0 - s[raw])),
                           _bits(m[kept] / (1.0 - c[kept])))
        if eye == 1.0:
            nan = torch.isnan(s)
            assert bool((c[~nan] == 1.0).all())
            assert bool(torch.isnan(c[nan]).all())


def _butterfly(vals, better):
    """K6's warp reduction over 32 lanes: each lane's (value, index) pair,
    then five rounds of exchange with lane ^ off, keeping the better pair;
    every lane must end with the same index."""
    lanes = list(vals)
    for off in (16, 8, 4, 2, 1):
        lanes = [lanes[x] if better(lanes[x], lanes[x ^ off]) else lanes[x ^ off]
                 for x in range(32)]
    assert len({at for _, at in lanes}) == 1
    return lanes[0][1]


@pytest.mark.parametrize("L1", [26, 32, 68])
def test_parcel_origin_reductions_match_torch(L1):
    """ihmin (first minimum of hm where it decreases) and nk (first
    maximum of hm at or below ihmin), as K6 reduces them over the warp
    (lane l owns levels l, l + 32, ...), against the plain pipeline's
    ``torch.argmin`` / ``torch.argmax``, on profiles with ties, signed
    zeros and infinities."""
    rs = np.random.default_rng(L1)
    inf = float("inf")
    for trial in range(300):
        hm = rs.choice([-1.0, 0.0, -0.0, 1.0, 2.0, 3.0, inf], L1) \
            if trial % 2 else rs.integers(0, 6, L1).astype(float)
        hm = torch.as_tensor(hm.astype(np.float32))
        nl = L1 - 1
        lev = torch.arange(L1)
        cand = torch.cat([torch.zeros(1, dtype=torch.bool), hm[1:] < hm[:-1]])
        ih = int(torch.argmin(torch.where(cand, hm, torch.tensor(inf))))
        ih = min(ih if bool(cand.any()) else nl - 1, nl - 2)
        nk = int(torch.argmax(torch.where(lev <= ih, hm, torch.tensor(-inf))))

        def lane_min(lane):
            best, at = inf, L1
            for k in range(lane, L1, 32):
                if k >= 1 and hm[k] < hm[k - 1] and hm[k] < best:
                    best, at = float(hm[k]), k
            return best, at

        at = _butterfly([lane_min(x) for x in range(32)],
                        lambda a, b: not (b[0] < a[0]
                                          or (b[0] == a[0] and b[1] < a[1])))
        best = min(lane_min(x)[0] for x in range(32))
        k_ih = nl - 1 if not bool(cand.any()) else (at if best < inf else 0)
        assert min(k_ih, nl - 2) == ih

        def lane_max(lane):
            best, at = 0.0, L1
            for k in range(lane, ih + 1, 32):
                v = float(hm[k])
                if v == v and (at == L1 or v > best):
                    best, at = v, k
            return best, at

        k_nk = _butterfly([lane_max(x) for x in range(32)],
                          lambda a, b: not (b[1] != L1 and (
                              a[1] == L1 or b[0] > a[0]
                              or (b[0] == a[0] and b[1] < a[1]))))
        assert k_nk == nk


def test_redist_commutes_with_a_permutation(synthetic):
    """Particles spread over the convecting and the other columns at all
    heights, their uniforms injected: the plain redistribution of a random
    permutation of them is the permutation of its result, z bitwise and the
    moved count equal."""
    grid, kern, steps = synthetic
    out = steps[-1]
    n = 4096
    rs = np.random.default_rng(21)
    jy, ix = np.nonzero(out.lconv.reshape(grid.ny, grid.nx).numpy())
    sel = rs.integers(0, len(jy), n)
    x = np.where(rs.uniform(size=n) < 0.8, ix[sel] + rs.uniform(-0.49, 0.49, n),
                 rs.uniform(0.0, grid.nx - 1, n)).astype(np.float32)
    y = np.where(rs.uniform(size=n) < 0.8, jy[sel] + rs.uniform(-0.49, 0.49, n),
                 rs.uniform(0.0, grid.ny - 1, n)).astype(np.float32)
    z = np.where(rs.uniform(size=n) < 0.5, rs.uniform(5.0, 400.0, n),
                 rs.uniform(5.0, 14000.0, n)).astype(np.float32)
    p = empty_particles(n, device="cpu").replace(
        x_hi=torch.as_tensor(x), y_hi=torch.as_tensor(y),
        z=torch.as_tensor(z),
        active=torch.as_tensor(rs.uniform(size=n) < 0.97),
        itra=torch.as_tensor(np.where(rs.uniform(size=n) < 0.95, 0, 900)
                             .astype(np.int32)))
    rn = torch.as_tensor(rs.uniform(size=n).astype(np.float32))
    perm = torch.as_tensor(rs.permutation(n))
    q = p.replace(**{f: getattr(p, f)[perm] for f in
                     ("x_hi", "y_hi", "z", "active", "itra")})
    args = (out.fmassfrac, out.rlevmass, out.phconv, out.sub, out.uvzlev,
            out.pconv, out.tconv, out.lconv, 900, 0, kern.nl, grid.nx,
            grid.ny)
    a, ma = tconv.redist_plain(p, rng.Key(5, 3), *args, rn=rn)
    b, mb = tconv.redist_plain(q, rng.Key(5, 3), *args, rn=rn[perm])
    assert int(ma) == int(mb) > 0
    assert torch.equal(_bits(b.z), _bits(a.z[perm]))
    assert bool((a.z != p.z).any())
