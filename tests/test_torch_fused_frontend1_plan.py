"""K2's schedule on the fused front ends' shared load path
(``radioframe_torch/kernels/frontend_plan.py``, single-stage shape), whose
index maps ``csrc/fused_frontend.cu`` mirrors through ``csrc/frontend.cuh``:
the plan of strips, chunks and ring stages with no stage-2 rows, the copy path
each input form and alignment takes, and the plain executor
``execute_single``, which walks strips and chunks with the mixed history
carried from chunk to chunk and each strip's prologue read from the tail.

The executor is held bit-equal to ``plain_fused_frontend`` (y) for the full
kernel and K8's no_osc, osc_only and copy_only variants, its power sum to
sum |x|^2 at rtol 1e-6, and against the JAX package's K2 in Pallas interpret
mode over 3 streamed blocks (5e-4, the reference's front-end bound; acc and
tail bit-equal under a DDS word that wraps every block). Sizes: the plan at
the flagship's C=128, T=131072 and at R=32; the executor at C=3-5,
T=4096-20480."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.kernels.fused_frontend import FusedFrontend as JFused
from radioframe.ops import filter_design as FD
from radioframe_torch.kernels import frontend_plan as fp
from radioframe_torch.kernels.fused_frontend import PROBE_TILE, FusedFrontend, plain_fused_frontend
from radioframe_torch.ops.nco import freq_word

torch.set_num_threads(2)

SM_SHARED = 228 * 1024  # an H100 SM's shared memory; each block also holds 1 KB


def _resident(smem: int, sms: int = 132) -> int:
    """Resident 256-thread blocks on an H100 at ``smem`` bytes each."""
    return sms * min(8, SM_SHARED // (smem + 1024))


def _front(R: int) -> FusedFrontend:
    """K2 with a CIC(R, 4)'s equivalent taps: J0 = 4 at R = 8 (29 taps) and
    at R = 32 (125 taps, adc_61m44's)."""
    return FusedFrontend(FD.cic_equivalent_taps(R, 4, 1), R)


def _plan(ff, xr, xi, C, **kw):
    """The single-stage plan with the wrapper's ring stages unless given."""
    form, align = fp.input_form(xr, xi)
    return fp.plan(C, xr.shape[1], ff.R, ff.J0, 1, 0, elt=4, form=form, align=align,
                   resident=_resident, stage2=False, **{"stages": ff.stages, **kw})


def _layout_bytes(R, J0, q, stages, form):
    """csrc/frontend.cuh layout() with stage2 off, written out: mbarriers,
    the ring, the taps, the power reduction and the phase-major window."""
    chunk = q * R
    plane = -(-(2 * chunk * 4 + 16) // 16) * 16 if form == "pair" else -(-(chunk * 4 + 16) // 16) * 16
    stage = plane if form == "pair" else 2 * plane
    nf = fp.padded_frames(J0 + q, R)
    floats = -(-(J0 + 1) * R // 4) * 4 + 8 + 2 * R * nf
    return -(-8 * stages // 16) * 16 + stages * stage + 4 * floats


# --- the plan ------------------------------------------------------------------------------


def test_flagship_single_stage_plan():
    """C=128, T=131072, R=8 on 132 SMs: 2048-sample chunks of 256 outputs
    (one a thread), K2's two ring stages in a 49,648-byte block of the
    interleaved view (4 blocks an SM), 4 strips a channel; no stage-2
    batch. Three stages: 66,064 bytes, 3 blocks an SM, 3 strips."""
    ff = _front(8)
    assert ff.stages == 2
    v = torch.view_as_real(torch.zeros((128, 131072), dtype=torch.complex64))
    p = ff.plan(v[..., 0], v[..., 1], 128, resident=_resident)
    assert (p.q2, p.chunk, p.chunks, p.strips, p.per_strip, p.stages) == (256, 2048, 64, 4, 16, 2)
    assert (p.form, p.copy, p.width, p.smem, p.batch, p.stage2) == ("pair", "bulk", 16, 49648,
                                                                     1, False)
    assert p.smem == _layout_bytes(8, 4, 256, 2, "pair") and _resident(p.smem) == 528
    assert "one stage" in fp.describe(p)
    ff.stages = 3
    p3 = ff.plan(v[..., 0], v[..., 1], 128, resident=_resident)
    assert (p3.strips, p3.per_strip, p3.smem) == (3, 22, 66064)
    assert p3.smem == _layout_bytes(8, 4, 256, 3, "pair") and _resident(p3.smem) == 396


def test_r32_plan():
    """adc_61m44's CIC(32, 4) at C=5, T=96000: 2048-sample chunks of 64
    outputs, one chunk a strip (5 channels leave the card's blocks to the
    strips), the last chunk ragged."""
    ff = _front(32)
    assert ff.J0 == 4
    x = torch.zeros((2, 5, 96000))
    p = _plan(ff, x[0], x[1], 5)
    assert (p.q2, p.chunk, p.chunks, p.strips, p.per_strip) == (64, 2048, 47, 47, 1)
    assert (p.copy, p.smem) == ("bulk", _layout_bytes(32, 4, 64, 2, "planes"))
    assert p.smem == 58352


@pytest.mark.parametrize("C,T,R,kw", [
    (128, 131072, 8, {}), (128, 131072, 8, dict(strips=5)), (5, 20000, 8, {}),
    (5, 20000, 8, dict(chunk=512, strips=3)), (5, 96000, 32, {}), (3, 8000, 4, dict(chunk=600)),
    (2, 1024, 8, dict(stages=2))])
def test_single_stage_plan_covers_every_output_once(C, T, R, kw):
    """Strips of per_strip chunks partition the chunks, chunks of q outputs
    the block's T/R outputs; a chunk holds at least J0 outputs (the history
    moves forward without overlap) and the layout fits a block."""
    p = fp.plan(C, T, R, 4, 1, 0, elt=4, form="planes", align=16, resident=_resident,
                stage2=False, **kw)
    M = T // R
    covered = np.zeros(M, int)
    for s in range(p.strips):
        k0, k1 = s * p.per_strip, min(p.chunks, (s + 1) * p.per_strip)
        assert k1 > k0
        for k in range(k0, k1):
            covered[k * p.q2:min(M, (k + 1) * p.q2)] += 1
    assert (covered == 1).all()
    assert p.q2 >= 4 and p.chunk == p.q2 * R and p.batch == 1
    assert p.smem == fp.smem_bytes(R, 4, 1, 0, p.q2, p.stages, "planes", 4, stage2=False)
    assert p.smem == _layout_bytes(R, 4, p.q2, p.stages, "planes") <= fp.SMEM_LIMIT
    if "strips" not in kw:
        assert C * p.strips <= max(C, _resident(p.smem))


def test_single_stage_plan_refuses_a_second_stage():
    with pytest.raises(ValueError, match="single-stage"):
        fp.plan(4, 8192, 8, 4, 4, 24, elt=4, form="pair", align=16, resident=_resident,
                stage2=False)


@pytest.mark.parametrize("case,form,copy,width", [
    ("planes", "planes", "bulk", 16), ("complex view", "pair", "bulk", 16),
    ("wideband", "planes", "bulk", 16), ("wideband complex view", "pair", "bulk", 16),
    ("column offset 1", "planes", "async", 4), ("column offset 2", "planes", "async", 8),
    ("complex view one float in", "pair", "async", 4),
    ("every other sample", "gather", "gather", 4)])
def test_single_stage_alignment_classes(case, form, copy, width):
    """K2's copy path from the input's form and the alignment of every copy's
    start and length (C=4, T=8192, R=8)."""
    C, T = 4, 8192
    if case.endswith("complex view"):
        rows = 1 if case.startswith("wideband") else C
        v = torch.view_as_real(torch.zeros((rows, T), dtype=torch.complex64))
        xr, xi = v[..., 0], v[..., 1]
    elif case == "complex view one float in":
        v = torch.zeros((C, 2 * T + 1))[:, 1:].unflatten(1, (T, 2))
        xr, xi = v[..., 0], v[..., 1]
    elif case.startswith("column offset"):
        off = int(case[-1])
        x = torch.zeros((2, C, T + off))
        xr, xi = x[0, :, off:], x[1, :, off:]
    elif case == "every other sample":
        x = torch.zeros((2, C, 2 * T))
        xr, xi = x[0, :, ::2], x[1, :, ::2]
    else:
        x = torch.zeros((2, 1 if case == "wideband" else C, T))
        xr, xi = x[0], x[1]
    p = _plan(_front(8), xr, xi, C)
    assert (p.form, p.copy, p.width) == (form, copy, width)


def test_no_tr_plan_is_one_gathered_tile_a_strip():
    """K8's no_tr reads each probe tile permuted: one chunk of PROBE_TILE
    outputs a strip, each with its own prologue, on the gather path, whatever
    the knobs say."""
    ff = _front(8)
    ff.strips, ff.chunk = 2, 4096
    x = torch.zeros((2, 128, 131072))
    p = ff.plan(x[0], x[1], 128, "no_tr", resident=_resident)
    assert (p.q2, p.per_strip, p.strips, p.copy, p.form) == (PROBE_TILE, 1, 128, "gather",
                                                             "gather")
    assert p.chunk == PROBE_TILE * 8
    p_full = ff.plan(x[0], x[1], 128, resident=_resident)
    assert (p_full.strips, p_full.chunk) == (2, 4096)


# --- the executor --------------------------------------------------------------------------


def _block(rng, form: str, C: int, T: int):
    """(xr, xi) planes of one block in ``form``: f32 planes, the interleaved
    complex view, a shared (1, T) row, planes viewed one column in."""
    if form == "complex view":
        v = torch.view_as_real(torch.from_numpy(
            (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)))
        return v[..., 0], v[..., 1]
    pad = 1 if form == "column offset" else 0
    x = torch.from_numpy(rng.standard_normal((2, 1 if form == "wideband" else C, T + pad))
                         .astype(np.float32))
    return x[0, :, pad:], x[1, :, pad:]


EXEC_CASES = {  # label -> (R, C, T, input form, plan knobs)
    "ragged": (8, 5, 20000, "f32", {}),
    "ragged strips": (8, 5, 20000, "f32", dict(chunk=512, strips=3)),
    "complex view": (8, 4, 16384, "complex view", dict(chunk=1024, strips=4)),
    "wideband": (8, 4, 8192, "wideband", dict(chunk=1024, strips=2, stages=2)),
    "column offset": (8, 3, 8192, "column offset", dict(chunk=1024)),
    "R=32": (32, 3, 20480, "f32", dict(strips=3)),
}


@pytest.mark.parametrize("variant", fp.SINGLE_VARIANTS)
@pytest.mark.parametrize("case", list(EXEC_CASES))
def test_execute_single_is_the_plain_version(rng, case, variant):
    """The executor's walk (strips, chunk joins, each strip's prologue from
    the tail) gives plain_fused_frontend's y bit for bit, and its per-strip
    power partials sum |x|^2 within rtol 1e-6; a random tail and
    accumulator."""
    R, C, T, form, kw = EXEC_CASES[case]
    ff = _front(R)
    xr, xi = _block(rng, form, C, T)
    words = torch.from_numpy(freq_word(np.linspace(-5e5, 5e5, C), 1_536_000.0))
    acc = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, C).astype(np.int32))
    tail = torch.complex(torch.randn(C, ff.H), torch.randn(C, ff.H))
    p = _plan(ff, xr, xi, C, **kw)
    y_e, p_e = fp.execute_single(p, ff.w1, xr, xi, tail, acc, words, variant)
    y_p, p_p = plain_fused_frontend(ff, xr, xi, tail, acc, words, variant)
    assert y_e.shape == (C, T // R)
    torch.testing.assert_close(y_e, y_p, rtol=0, atol=0)
    x2 = (xr.double() ** 2 + xi.double() ** 2).sum(dim=-1).expand(C)
    np.testing.assert_allclose(p_e.numpy(), x2.numpy(), rtol=1e-6)
    np.testing.assert_allclose(p_p.numpy(), x2.numpy(), rtol=1e-6)


def test_execute_single_refuses_what_it_does_not_run():
    ff = _front(8)
    x = torch.zeros((2, 2, 4096))
    p = _plan(ff, x[0], x[1], 2)
    args = (ff.w1, x[0], x[1], torch.zeros((2, ff.H), dtype=torch.complex64),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="variant"):
        fp.execute_single(p, *args, "no_tr")
    p2 = fp.plan(2, 4096, 8, 4, 4, 24, elt=4, form="planes", align=16, resident=_resident)
    with pytest.raises(ValueError, match="single-stage"):
        fp.execute_single(p2, *args)


@pytest.fixture(scope="module")
def j_step():
    return jax.jit(lambda f, st, x, w: f.step(st, x, w), static_argnums=0)


@pytest.mark.parametrize("case", ["ragged strips", "complex view", "wideband", "R=32"])
def test_execute_single_matches_jax_streamed(j_step, rng, case):
    """Three streamed blocks through the executor against the JAX K2 in
    interpret mode (5e-4); the wrapper's acc and tail bit-equal to the JAX
    state, with a DDS word that wraps every block."""
    R, C, T, form, kw = EXEC_CASES[case]
    T = min(T, 8192)
    h = FD.cic_equivalent_taps(R, 4, 1)
    ff, jf = FusedFrontend(h, R), JFused(h, R, interpret=True)
    words = freq_word(np.linspace(-5e5, 5e5, C), 1_536_000.0)
    words[0] = 2 ** 31 - 7
    w_t = torch.from_numpy(words)
    st_t, st_j = ff.init_state(C), jf.init_state(C)
    for _ in range(3):
        xr, xi = _block(rng, form, C, T)
        p = _plan(ff, xr, xi, C, **kw)
        y_e, _ = fp.execute_single(p, ff.w1, xr, xi, st_t["tail"], st_t["acc"], w_t)
        x = (xr.numpy() + 1j * xi.numpy()).astype(np.complex64)
        st_j, y_j = j_step(jf, st_j, jnp.asarray(x), jnp.asarray(words))
        np.testing.assert_allclose(y_e.numpy(), np.asarray(y_j), atol=5e-4, rtol=0)
        st_t = ff.next_state(st_t, xr, xi, w_t)
        np.testing.assert_array_equal(st_t["acc"].numpy(), np.asarray(st_j["acc"]))
        np.testing.assert_array_equal(st_t["tail"].numpy(), np.asarray(st_j["tail"]))


# --- the wrapper ---------------------------------------------------------------------------


def test_wrapper_power_is_the_full_variants(rng):
    """step/step_planes return the power sum on request (the plain version's
    on CPU tensors, no launch counted); a cost variant returns none."""
    ff = _front(8)
    C, T = 4, 4096
    x = torch.from_numpy((rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T)))
                         .astype(np.complex64))
    words = torch.from_numpy(freq_word(np.linspace(-1e5, 1e5, C), 1_536_000.0))
    st, y, power = ff.step(ff.init_state(C), x, words, return_power=True)
    _, y2 = ff.step(ff.init_state(C), x, words)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    np.testing.assert_allclose(power.numpy(), (np.abs(x.numpy().astype(np.complex128)) ** 2)
                               .sum(axis=-1), rtol=1e-6)
    assert ff.input_scale == 1.0 and ff.launches == 0
    v = torch.view_as_real(x)
    with pytest.raises(ValueError, match="full variant"):
        ff.step_planes(ff.init_state(C), v[..., 0], v[..., 1], words, variant="copy_only",
                       return_power=True)
