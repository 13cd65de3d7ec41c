"""Port parity: the double-single position arithmetic is bitwise JAX's.

``ds_add`` is an error-free two-sum; any contraction or reassociation
would change its low word, so the comparison is exact (tolerance 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import jax.numpy as jnp  # noqa: E402
from flexpart_tpu.core import state as jstate  # noqa: E402
from flexpart_tpu_torch import interop  # noqa: E402
from flexpart_tpu_torch.core import state as tstate  # noqa: E402


def _inputs(case, n=4096, seed=0):
    rs = np.random.default_rng(seed)
    if case == "random":
        hi = rs.uniform(-400.0, 400.0, n).astype(np.float32)
        d = rs.normal(0.0, 3.0, n).astype(np.float32)
    else:   # large |hi| with tiny increments: the low word does the work
        hi = (rs.choice([-1.0, 1.0], n) * rs.uniform(1e3, 1e7, n)).astype(np.float32)
        d = (rs.normal(0.0, 1.0, n) * 10.0 ** rs.uniform(-9, -3, n)).astype(np.float32)
    lo = (rs.normal(0.0, 1.0, n) * np.abs(hi) * 2.0 ** -26).astype(np.float32)
    return hi, lo, d


@pytest.mark.parametrize("case", ["random", "large_hi_tiny_d"])
def test_ds_add_bitwise(case):
    hi, lo, d = _inputs(case)
    jh, jl = jstate.ds_add(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(d))
    th, tl = tstate.ds_add(*map(torch.as_tensor, (hi, lo, d)))
    np.testing.assert_array_equal(th.numpy().view(np.int32),
                                  np.asarray(jh).view(np.int32))
    np.testing.assert_array_equal(tl.numpy().view(np.int32),
                                  np.asarray(jl).view(np.int32))
    # and repeated accumulation stays bitwise equal
    for _ in range(50):
        jh, jl = jstate.ds_add(jh, jl, jnp.asarray(d))
        th, tl = tstate.ds_add(th, tl, torch.as_tensor(d))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_ds_value_and_set():
    hi, lo, _ = _inputs("random", seed=1)
    np.testing.assert_array_equal(
        tstate.ds_value(torch.as_tensor(hi), torch.as_tensor(lo)).numpy(),
        np.asarray(jstate.ds_value(jnp.asarray(hi), jnp.asarray(lo))))
    th, tl = tstate.ds_set(torch.as_tensor(hi))
    jh, jl = jstate.ds_set(jnp.asarray(hi))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_particles_roundtrip_keeps_dtypes():
    jp = jstate.empty_particles(64, nspec=2)
    jp = jp._replace(cbt=jnp.full(64, -1, jnp.int8),
                     active=jnp.arange(64) % 2 == 0)
    tp = interop.particles_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items()}, "cpu")
    empty = tstate.empty_particles(64, nspec=2, device="cpu")
    for f in tstate.FIELDS:
        assert getattr(tp, f).dtype == getattr(empty, f).dtype, f
    back = interop.particles_to_numpy(tp)
    for f in tstate.FIELDS:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jp, f)))
    assert empty.cbt.dtype == torch.int8 and empty.active.dtype == torch.bool
    assert empty.itra.dtype == torch.int32


def test_copied_constants_match_the_jax_package():
    import flexpart_tpu.config as jconfig
    import flexpart_tpu.constants as jc
    import flexpart_tpu_torch.config as tconfig
    import flexpart_tpu_torch.constants as tc
    names = [k for k in vars(tc) if k.isupper()]
    assert len(names) >= 10
    for k in names:
        assert getattr(tc, k) == getattr(jc, k), k
    og = dict(outlon0=-1.0, outlat0=2.0, numxgrid=3, numygrid=4, dxout=0.5,
              dyout=0.25, outheights=(10.0, 20.0))
    assert tconfig.OutGrid(**og).numzgrid == jconfig.OutGrid(**og).numzgrid


def test_warm_vector_math_keeps_the_thread_count():
    """The warm-up of torch's MKL vector math (``utils/cpu.py``: each
    function's first call of the process made on one thread) names only
    functions torch has, and leaves torch's intra-op threads as it found
    them."""
    from flexpart_tpu_torch.utils.cpu import VML_FUNCTIONS
    before = torch.get_num_threads()
    torch.set_num_threads(3)
    try:
        warm_vector_math()
        assert torch.get_num_threads() == 3
    finally:
        torch.set_num_threads(before)
    assert all(callable(getattr(torch, name)) for name in VML_FUNCTIONS)
