"""K4 CBL's design against its sources and against the branch it defers.

K4 CBL (the fixed step with the skewed convective boundary layer) is three
launches on the card (``csrc/advance.cu``): the start defers every
particle whose substeps take the skewed branch into a queue, the skewed
launch runs the queue's substeps on consecutive lanes, the end recomputes
each deferred particle's start and ends its step.  No compiler runs on the
CPU, so what the wrapper and the bound readers assume of the source is
held against its text here: the queue's words against the wrapper's
(``core/advance.py::K4_CBL_QUEUE_WORDS``), which stage writes and reads
which rows, the queue's length in ``counts[3]``, the three launches a
call and the one count an entry takes for them, the stock and TILE
kernels' body free of the CBL's stages, and the measurement builds'
defines (``FP_CBL_LANES``, ``FP_CBL_CALLS``) in no build that a path
launches.

The wrapper sizes the queue at a row a particle: which particles go is
known only on the card.  The rule of the branch the start defers
(``advance.k4_cbl_deferred``: scheduled, z / h <= 1, -h/L > 5 and dtf /
TL_w < 0.5 from the start's turbulence) is held on ``test_torch_cbl``'s
convective met against the JAX package's branch
(``flexpart_tpu/core/advance.py:321-381``: ``use_lin & cbl_zone``, from
its own sampling and Hanna), bitwise as a mask, and against
``chip_smoke.fixed_cbl_shares``' count, which the smoke prints; the
source's deferral test is the same expression as the substeps' branch.
"""
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
from flexpart_tpu_torch.utils.cpu import warm_vector_math  # noqa: E402
warm_vector_math()

import test_torch_cbl as tc  # noqa: E402
from test_torch_cbl import met  # noqa: E402,F401
from flexpart_tpu.core import hanna as jhanna  # noqa: E402
from flexpart_tpu.core import interp as jinterp  # noqa: E402
from flexpart_tpu_torch import _build  # noqa: E402
from flexpart_tpu_torch.core import advance as tadv  # noqa: E402
from flexpart_tpu_torch.core import interp as tinterp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

MEASUREMENT_DEFINES = ("FP_CBL_LANES", "FP_CBL_CALLS")


def _text(path):
    return re.sub(r"//[^\n]*", "", Path(path).read_text())


def _advance():
    return _text(_build.ADVANCE.source)


def _function(text, name):
    """The body of the function or kernel ``name`` (its definition)."""
    m = re.search(r"\b%s\((?:[^()]|\([^()]*\))*\)\s*(?:->\s*\w+\s*)?\{"
                  % re.escape(name), text)
    assert m, name
    depth, k = 0, m.end() - 1
    for k in range(m.end() - 1, len(text)):
        depth += {"{": 1, "}": -1}.get(text[k], 0)
        if depth == 0:
            break
    return text[m.start():k + 1]


def test_queue_words_match_the_wrapper():
    """The queue's rows (QueueRow, QUEUE_WORDS of them) are
    K4_CBL_QUEUE_WORDS, each row `n` words (the queue's stride is a.n),
    and the wrapper's scratch holds them: one row a field, a word a
    particle, float32."""
    text = _advance()
    body = re.search(r"enum QueueRow : int \{(.*?)\};", text, re.S).group(1)
    rows = [r.strip() for r in body.split(",") if r.strip()]
    assert rows[-1] == "QUEUE_WORDS"
    assert len(rows) - 1 == tadv.K4_CBL_QUEUE_WORDS
    assert "const Queue q = {static_cast<float*>(queue), a.n};" in text
    q = tadv.k4_cbl_queue(48, "cpu")
    assert q.shape == (tadv.K4_CBL_QUEUE_WORDS, 48)
    assert q.dtype == torch.float32 and q.is_contiguous()


@pytest.mark.parametrize("fn, rows", [
    # the start's entry: every row but the substeps' NaN flag
    ("store_entry", {"SLOT", "Z", "WP", "CBT", "H", "UST", "WST", "OL",
                     "RHO", "DRHODZ"}),
    # the skewed launch's outcome
    ("skewed_substeps", {"Z", "WP", "CBT", "NAN"}),
])
def test_each_stage_writes_its_rows(fn, rows):
    body = _function(_advance(), fn)
    assert set(re.findall(r"q_at\(q, Q_(\w+), k\) =", body)) == rows


@pytest.mark.parametrize("fn, rows", [
    ("load_entry", {"SLOT", "Z", "WP", "CBT", "H", "UST", "WST", "OL", "RHO",
                    "DRHODZ"}),
    ("load_outcome", {"SLOT", "Z", "WP", "CBT", "NAN"}),
])
def test_each_stage_reads_the_rows_written_before_it(fn, rows):
    body = _function(_advance(), fn)
    assert set(re.findall(r"q_at\(q, Q_(\w+), k\)(?! =)", body)) == rows


def test_queue_length_is_the_fourth_count():
    """The start appends with one atomicAdd a warp on counts[3], the
    skewed launch reads its length there, the end too; the wrapper zeroes
    K4_COUNT_WORDS = 4 counts and returns the fourth as
    StepDiag.deferred with the CBL."""
    text = _advance()
    start = _function(text, "advance_cbl_kernel")
    assert "atomicAdd(&counts[3], __popc(deferred))" in start
    assert "store_entry(q, at, i, e)" in start
    assert "(q, counts + 3, a)" in text
    finish = _function(text, "advance_cbl_finish_kernel")
    assert "const long long n = counts[3];" in finish
    assert tadv.K4_COUNT_WORDS == 4
    src = _text(tadv.__file__)
    assert "torch.zeros(K4_COUNT_WORDS, dtype=i32, device=dev)" in src
    assert "deferred=counts[3] if cfg.cblflag else None" in src


def test_deferral_test_is_the_skewed_branch_of_the_substeps():
    """The start defers exactly the particles that would enter
    cbl_substeps' skewed branch: in the column's zone with dtf / TL_w <
    0.5 of the turbulence the substeps start from; a deferred particle's
    start writes nothing, and the start's own substeps compile no skewed
    code (cbl_substeps<false>)."""
    text = _advance()
    one = _function(text, "cbl_one")
    assert "if (col.zone && a.dtf / tw.tlw < 0.5f)" in one
    assert "return Outcome{false, false, false, true};" in one
    assert "cbl_substeps<false>(a, i, 0u, tw, a.dtf," in one
    common = _text(_build.CSRC / "advance_common.cuh")
    subs = _function(common, "cbl_substeps")
    assert "const float dtftlw = dtf / t.tlw;" in subs
    assert "const bool use_lin = dtftlw < 0.5f;" in subs
    assert "if (SKEWED && col.zone) {" in subs
    # the skewed launch starts its substeps where the single thread did:
    # Hanna's turbswitch form at the start height, row 0 of tag 2
    sk = _function(text, "skewed_substeps")
    assert "hanna<true>(e.z, e.h, e.ust, e.wst, e.ol)" in sk
    assert "site_words(pw, a, 2, i, 0u);" in sk
    assert "fp::normal_pair(pw[0], pw[1], d2, d2_odd);" in sk


def test_a_call_is_three_launches_and_one_count():
    """K4 CBL's stages launch three kernels, each launch's error returned;
    its entries (advance.cbl, advance.tile_cbl) count a call once."""
    launcher = _function(_advance(), "fp_advance")
    stages = launcher[launcher.index("if (a.cblflag) {\n#if"):
                      launcher.index("using Yes = std::true_type;")]
    assert stages.count("<<<") == 3
    assert stages.count("cudaGetLastError()") == 3

    class Kernel:
        calls = 0

        def launch(self, *args):
            Kernel.calls += 1

    for entry in (_build.ADVANCE_CBL, _build.ADVANCE_TILE_CBL):
        saved, before = entry.kernel, entry.launches
        entry.kernel = Kernel()
        try:
            entry(1, 2, 3)
            entry(1, 2, 3)
            assert entry.launches - before == 2
        finally:
            entry.kernel, entry.launches = saved, before
    assert Kernel.calls == 4


def test_measurement_builds_are_no_path_build():
    """The lane counter (FP_CBL_LANES) and the skewed substep as a call
    (FP_CBL_CALLS) are in none of the kernels a path launches: no such
    define in their flags or parts' commands, each guarded in the source;
    chip_smoke's lanes and calls builds carry them and build under names
    of their own."""
    for k in _build.KERNELS:
        flags = " ".join(k.defines) + " ".join(
            " ".join(k._part_flags(part)) for part in range(k.parts))
        assert not any(d in flags for d in MEASUREMENT_DEFINES), k.name
    common = _text(_build.CSRC / "advance_common.cuh")
    assert "#if defined(FP_CBL_LANES) && FP_CBL_LANES" in common
    assert "#if defined(FP_CBL_LANES) && FP_CBL_LANES" in _advance()
    # the counter sits in the skewed branch alone
    subs = _function(common, "cbl_substeps")
    assert subs.count("count_cbl_lanes();") == 1
    assert re.search(r"if \(SKEWED && col\.zone\) \{\s*count_cbl_lanes\(\);",
                     subs)
    lanes = chip_smoke.k4_cbl_lanes_build()
    assert lanes is chip_smoke.k4_cbl_lanes_build()
    assert set(lanes.defines) == {"-DFP_PART=6", "-DFP_CBL_LANES=1"}
    assert lanes._lib_path() != _build.ADVANCE._lib_path(6)
    assert lanes._lib_path() != chip_smoke.k4_cbl_calls_build()._lib_path()


@pytest.mark.parametrize("ifine", [11, 20])
def test_deferred_rule_is_the_jax_branch(met, ifine):
    """advance.k4_cbl_deferred, the rule the queue is sized and held by,
    against the JAX package's branch on the same particles and fields:
    the scheduled boundary-layer particles with use_lin & cbl_zone,
    bitwise as a mask; against chip_smoke.fixed_cbl_shares' count; within
    the queue's room."""
    grid, (j0, j1), (t0, t1) = met
    jcfg, jprm, tcfg, tprm = tc._cfgs(grid, 0, ifine)
    p = tc._particles(grid)
    tp = tc._port(p)
    itime = tc.LSYNC
    a = tadv.advance_args(tcfg, tprm, itime, 0, tc.MEM1)
    tw = tadv._time_weights(itime, 0, tc.MEM1, tprm, tcfg)[:4]
    tables = tinterp.build_step_tables_quad(t0, t1, *tw,
                                            dtype=tcfg.table_dtype)
    got = tadv.k4_cbl_deferred(tp, t0.height, tables, tcfg, a)

    # JAX: its start's sampling and Hanna, its branch's two tests
    # advance_all's time weights (flexpart_tpu/core/advance.py:806-815)
    dt1, dt2 = jnp.float32(itime), jnp.float32(tc.MEM1 - itime)
    dtt = 1.0 / (dt1 + dt2)
    edt1 = jnp.float32(itime + tc.LSYNC)
    edt2 = jnp.float32(tc.MEM1 - itime - tc.LSYNC)
    edtt = 1.0 / jnp.maximum(edt1 + edt2, 1e-6)
    jt = jinterp.build_step_tables_quad(
        j0, j1, dt2 * dtt, dt1 * dtt, edt2 * edtt, edt1 * edtt,
        dtype=jnp.bfloat16 if jcfg.met_bf16 else jnp.float32)
    x = p.x_hi + p.x_lo
    y = p.y_hi + p.y_lo
    hw = jinterp.horiz_weights(x, y, grid.nx, grid.ny, True)
    indz, dz1 = jinterp.vert_weights(p.z, j0.height)
    h, _, ust, wst, ol, _ = jinterp.sample_all_quad(jt, hw, indz, dz1, x, y,
                                                    grid.nx, grid.ny)
    dtf = jnp.float32(tc.LSYNC / ifine)
    turb = jhanna.hanna(p.z, h, ust, wst, ol)
    want = np.asarray(p.active & (p.z / h <= 1.0) & ((-h / ol) > 5.0)
                      & (dtf / turb.tlw < 0.5))
    assert want.sum() > 0.1 * len(want)
    np.testing.assert_array_equal(got.numpy(), want)
    shares = chip_smoke.fixed_cbl_shares(tp, t0.height, tables, tcfg, a,
                                         itime)
    assert shares["calls"]["cbl_skewed_wp"] == int(got.sum()) * ifine
    assert int(got.sum()) <= tadv.k4_cbl_queue(tp.capacity, "cpu").shape[1]


def test_stock_body_holds_no_cbl_stage():
    """The stock and TILE kernels run advance_body, the whole step a
    thread with HANNA1 or TS, which holds none of K4 CBL's design: no
    stage, queue, skewed substep or NaN count; the CBL's kernels run
    cbl_one alone."""
    text = _advance()
    body = _function(text, "advance_body")
    for word in ("STAGE", "Queue", "SkewEntry", "cbl_substeps", "CBL",
                 "counts[2]", "counts[3]"):
        assert word not in body, word
    assert "pbl_substeps<TURB>(" in body
    for kernel in ("advance_kernel", "advance_tile_kernel"):
        k = _function(text, kernel)
        assert "advance_body<" in k and "cbl_one<" not in k, kernel
    for kernel in ("advance_cbl_kernel", "advance_cbl_finish_kernel"):
        k = _function(text, kernel)
        assert "cbl_one<" in k and "advance_body<" not in k, kernel
