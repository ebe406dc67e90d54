"""The host side of K1's load path (``radioframe_torch/kernels/frontend_plan.py``),
whose schedule and index maps ``csrc/fused_frontend2.cu`` mirrors: the plan
of strips, chunks and ring stages, the shared-memory layout, the copy path an
input's alignment allows, and the plain executor that walks strips and chunks
with the mixed and stage-1 histories carried as the kernel carries them.

The executor is held against ``plain_step`` (1e-5 of the output's scale) and
against the JAX package's K1 in Pallas interpret mode (5e-4, the reference's
front-end bound) over streamed blocks, for f32 planes, the interleaved complex
view, int16 counts (with rows whose starts are 2-byte aligned, read through
the async path's rounded byte ranges), a shared (1, T) wideband input, the
single-stage form and a ragged 2x2 decimation. Sizes are small: C = 3-4
channels, T = 8192-16384."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core.config import CicStage, FirStage, RxConfig
from radioframe.kernels.fused_frontend2 import FusedFrontend2 as JFused
from radioframe.ops import filter_design as FD
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe_torch.kernels import frontend_plan as fp
from radioframe_torch.kernels.fused_frontend2 import FusedFrontend2, plain_step
from radioframe_torch.ops.nco import freq_word

torch.set_num_threads(2)

FS = 1_536_000.0
SM_SHARED = 228 * 1024  # an H100 SM's shared memory; each block also holds 1 KB


def _resident(smem: int, sms: int = 132) -> int:
    """Resident 256-thread blocks on an H100 at ``smem`` bytes each (shared
    memory the only limit; 8 blocks an SM at most, by threads)."""
    return sms * min(8, SM_SHARED // (smem + 1024))


@pytest.fixture(scope="module")
def taps():
    """(flagship stage-1, stage-2 taps; the default RxConfig's)."""
    flag = JChain(RxConfig(fs_in=FS, channels=4, stages=(
        CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0))))._stage_taps
    small = JChain(RxConfig(channels=4, fuse_frontend=True, fuse_frontend_depth=2))._stage_taps
    return flag, small


def _front(taps, kind: str, int16: bool = False):
    """(port front end, JAX front end in interpret mode) of one stage plan."""
    (flag, small), scale = taps, (2.0 ** -15 if int16 else 1.0)
    if kind == "flagship":
        args = (flag[0], 8, flag[1], 4)
    elif kind == "single":
        args = (flag[0], 8)
    else:
        args = (small[0], 2, small[1], 2)
    return (FusedFrontend2(*args, input_scale=scale),
            JFused(*args, interpret=True, input_scale=scale))


def _plan(ff, xr, xi, C, **kw):
    form, align = fp.input_form(xr, xi)
    return fp.plan(C, xr.shape[1], ff.R, ff.J0, ff.R2, ff.J2, elt=xr.element_size(), form=form,
                   align=align, resident=_resident, **kw)


# --- the plan ------------------------------------------------------------------------------


@pytest.mark.parametrize("C,T,R1,J0,R2,J2,kw", [
    (128, 131072, 8, 4, 4, 24, {}), (128, 131072, 8, 4, 4, 24, dict(strips=5)),
    (5, 20000, 8, 4, 1, 0, {}), (5, 20000, 2, 2, 2, 64, dict(chunk=600)),
    (3, 8192, 8, 4, 4, 24, dict(strips=1, stages=2)), (7, 4800, 5, 3, 2, 9, {}),
    (2, 1024, 8, 4, 4, 24, {})])
def test_plan_covers_every_output_once(C, T, R1, J0, R2, J2, kw):
    """Strips of per_strip chunks partition the chunks, chunks of q2 outputs
    the block's M2 outputs; the halo is the filters' history; the layout
    fits a block and the planned strips fill the card without a second
    wave."""
    p = fp.plan(C, T, R1, J0, R2, J2, elt=4, form="planes", align=16, resident=_resident, **kw)
    M2 = T // (R1 * R2)
    covered = np.zeros(M2, int)
    for s in range(p.strips):
        k0, k1 = s * p.per_strip, min(p.chunks, (s + 1) * p.per_strip)
        assert k1 > k0  # no empty strip
        for k in range(k0, k1):
            covered[k * p.q2:min(M2, (k + 1) * p.q2)] += 1
    assert (covered == 1).all()
    assert p.chunk == p.q2 * R1 * R2 and p.chunks == -(-M2 // p.q2)
    assert p.q2 >= J2 and p.q2 * R2 >= J0  # the histories move forward without overlap
    assert p.smem == fp.smem_bytes(R1, J0, R2, J2, p.q2, p.stages, "planes", 4)
    assert p.smem <= fp.SMEM_LIMIT
    if "strips" not in kw:
        assert C * p.strips <= max(C, _resident(p.smem))


def test_flagship_plan():
    """C=128, T=131072 on 132 SMs: 2048-sample chunks (16 KB of interleaved
    f32), three stages in a 75,936-byte block (3 blocks an SM), 3 strips a
    channel: 384 blocks against 396 resident."""
    p = fp.plan(128, 131072, 8, 4, 4, 24, elt=4, form="pair", align=16, resident=_resident)
    assert (p.q2, p.chunk, p.chunks, p.strips, p.per_strip, p.stages) == (64, 2048, 64, 3, 22, 3)
    assert (p.copy, p.width, p.smem, p.batch) == ("bulk", 16, 75936, 4)
    assert _resident(p.smem) == 396


@pytest.mark.parametrize("J0,J2", [(4, 24), (2, 64), (4, 0)])
def test_halos_are_what_the_filters_need(taps, J0, J2):
    """The prologue's raw halo is the front end's carried tail, J2 R1 R2 + J0
    R1 samples: J0 mixed frames of stage-1 history, J2 stage-1 frames of
    stage-2 history (the padded polyphase taps' depth less one)."""
    ff = {(4, 24): _front(taps, "flagship"), (2, 64): _front(taps, "2x2"),
          (4, 0): _front(taps, "single")}[(J0, J2)][0]
    assert (ff.J0, ff.J2) == (J0, J2)
    assert ff.w1.shape == (J0 + 1, ff.R) and ff.w2.shape == (J2 + 1, ff.R2)
    assert ff.H_carry == J2 * ff.R * ff.R2 + J0 * ff.R


def test_long_filters_shrink_the_chunk():
    """A layout over the block's shared memory halves the chunk until it
    fits; a history too long for any chunk is refused."""
    big = fp.plan(4, 1 << 20, 8, 4, 4, 24, elt=4, form="pair", align=16, resident=_resident,
                  chunk=65536)
    assert big.smem <= fp.SMEM_LIMIT and big.q2 < 65536 // 32
    with pytest.raises(ValueError, match="too long"):
        fp.plan(4, 1 << 22, 8, 4, 4, 3000, elt=4, form="pair", align=16, resident=_resident)


def test_bank_padding():
    """Rows padded to 32/R mod 32: a warp's 32 consecutive samples (R rows
    of 32/R frames) fall in 32 distinct banks."""
    for R in (1, 2, 4, 8, 16, 32):
        n = fp.padded_frames(261, R)
        assert n >= 261 and n - 261 < 32
        banks = {(p * n + f) % 32 for p in range(R) for f in range(32 // R)}
        assert len(banks) == 32
    assert fp.padded_frames(100, 5) % 2 == 1


@pytest.mark.parametrize("case,form,copy,width", [
    ("planes", "planes", "bulk", 16), ("complex view", "pair", "bulk", 16),
    ("wideband", "planes", "bulk", 16), ("int16", "planes", "bulk", 16),
    ("int16 rows of T+3", "planes", "async", 4), ("column offset 1", "planes", "async", 4),
    ("column offset 2", "planes", "async", 8), ("int16 rows of T+4", "planes", "async", 8),
    ("complex view one float in", "pair", "async", 4),
    ("every other sample", "gather", "gather", 4)])
def test_alignment_classes(case, form, copy, width):
    """The copy path from the input's form and the alignment of every copy's
    start and length (C=4, T=8192, flagship decimation)."""
    C, T = 4, 8192
    if case.startswith("int16"):
        pad = {"int16": 0, "int16 rows of T+3": 3, "int16 rows of T+4": 4}[case]
        x = torch.zeros((2, C, T + pad), dtype=torch.int16)
        xr, xi = x[0, :, pad:], x[1, :, pad:]
    elif case == "complex view":
        v = torch.view_as_real(torch.zeros((C, T), dtype=torch.complex64))
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
    p = fp.plan(C, T, 8, 4, 4, 24, elt=xr.element_size(), resident=_resident,
                **dict(zip(("form", "align"), fp.input_form(xr, xi))))
    assert (p.form, p.copy, p.width) == (form, copy, width)


def test_copy_range_rounds_out():
    """The async path's byte range: rounded out to the width, the data at
    the shift; 2-byte starts (int16) read at most 2 bytes past either end."""
    assert fp.copy_range(4096, 64, 8) == (4096, 64, 0)
    assert fp.copy_range(4102, 64, 4) == (4100, 68, 2)
    a0, n, shift = fp.copy_range(4098, 4, 4)
    assert (a0, n, shift) == (4096, 8, 2) and a0 + n - (4098 + 4) == 2


# --- the executor --------------------------------------------------------------------------

FORMS = ["f32", "complex view", "int16", "int16 rows of T+3", "column offset", "wideband"]


def _block(rng, form: str, C: int, T: int):
    """(xr, xi) torch planes of one block in ``form``, and the same as numpy
    (rows, T) arrays for the JAX front end."""
    if form.startswith("int16"):
        pad = 3 if form == "int16 rows of T+3" else 0
        x = np.clip(np.round(rng.standard_normal((2, C, T + pad)) * 8000.0), -32768, 32767)
        x = torch.from_numpy(x.astype(np.int16))
        xr, xi = x[0, :, pad:], x[1, :, pad:]
    elif form == "complex view":
        v = torch.view_as_real(torch.from_numpy(
            (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)))
        xr, xi = v[..., 0], v[..., 1]
    else:
        pad = 1 if form == "column offset" else 0
        x = torch.from_numpy(rng.standard_normal((2, 1 if form == "wideband" else C, T + pad))
                             .astype(np.float32))
        xr, xi = x[0, :, pad:], x[1, :, pad:]
    return xr, xi, xr.numpy().copy(), xi.numpy().copy()


@pytest.fixture(scope="module")
def j_step():
    return jax.jit(lambda f, st, xr, xi, w: f.step_planes(st, xr, xi, w, return_power=True),
                   static_argnums=0)


@pytest.mark.parametrize("kind,form,C,T,kw", [
    ("flagship", "f32", 3, 16384, dict(chunk=1024, strips=3)),
    ("flagship", "complex view", 3, 16384, dict(chunk=2048, strips=2, stages=2)),
    ("flagship", "int16", 3, 16384, dict(chunk=1024)),
    ("flagship", "int16 rows of T+3", 3, 16384, dict(chunk=1024, strips=4)),
    ("flagship", "column offset", 3, 8192, dict(chunk=1024)),
    ("flagship", "wideband", 4, 8192, {}),
    ("single", "f32", 3, 8000, dict(chunk=512, strips=3)),
    ("2x2", "f32", 3, 10000, dict(chunk=600, strips=2))],
    ids=lambda v: v if isinstance(v, str) else None)
def test_executor_matches_plain_and_jax(taps, j_step, rng, kind, form, C, T, kw):
    """Three streamed blocks: the executor's y and power against plain_step
    (1e-5 of scale) and the JAX K1 (5e-4, power rtol 1e-5); the wrapper's
    acc and tail bit-equal to the JAX state, with a DDS word that wraps
    every block."""
    ff, jf = _front(taps, kind, int16=form.startswith("int16"))
    words = freq_word(np.linspace(-5e5, 5e5, C), FS)
    words[0] = 2 ** 31 - 7  # acc + word*T wraps every block
    w_t = torch.from_numpy(words)
    st_t, st_j = ff.init_state(C), jf.init_state(C)
    copies = set()
    for _ in range(3):
        xr, xi, nr, ni = _block(rng, form, C, T)
        p = _plan(ff, xr, xi, C, **kw)
        copies.add(p.copy)
        y_e, p_e = fp.execute(p, ff.w1, ff.w2, xr, xi, st_t["tail"], st_t["acc"], w_t)
        y_p, p_p = plain_step(ff, xr, xi, st_t["tail"], st_t["acc"], w_t)
        scale = max(1.0, float(y_p.abs().max()))
        assert float((y_e - y_p).abs().max()) <= 1e-5 * scale
        torch.testing.assert_close(p_e, p_p, rtol=1e-5, atol=0)
        st_j, y_j, p_j = j_step(jf, st_j, jnp.asarray(nr), jnp.asarray(ni), jnp.asarray(words))
        np.testing.assert_allclose(y_e.numpy(), np.asarray(y_j), atol=5e-4, rtol=0)
        np.testing.assert_allclose(p_e.numpy(), np.asarray(p_j), rtol=1e-5)
        st_t = ff.next_state(st_t, xr, xi, w_t)
        np.testing.assert_array_equal(st_t["acc"].numpy(), np.asarray(st_j["acc"]))
        np.testing.assert_array_equal(st_t["tail"].numpy(), np.asarray(st_j["tail"]))
    want = {"int16 rows of T+3": "async", "column offset": "async"}.get(form, "bulk")
    assert copies == {want}


def test_executor_strips_agree(taps, rng):
    """The strip count moves only the halo's re-read and the power sums'
    grouping: y equal to within rounding at 1, 2, 5 and 16 strips."""
    ff, _ = _front(taps, "flagship")
    C, T = 2, 16384
    xr, xi, _, _ = _block(rng, "f32", C, T)
    st = ff.init_state(C)
    st["tail"] = torch.complex(torch.randn(C, ff.H_carry), torch.randn(C, ff.H_carry))
    words = torch.from_numpy(freq_word(np.array([1e5, -2e5]), FS))
    ys = [fp.execute(_plan(ff, xr, xi, C, chunk=512, strips=s), ff.w1, ff.w2, xr, xi,
                     st["tail"], st["acc"], words)[0] for s in (1, 2, 5, 16)]
    for y in ys[1:]:
        assert float((y - ys[0]).abs().max()) <= 1e-6 * max(1.0, float(ys[0].abs().max()))


def test_single_stage_executor_matches_jax_single(rng):
    """The single-stage form (R2 = 1, J2 = 0, a stage-2 tap of 1.0) against
    the JAX single-stage K1 over two blocks."""
    h = FD.cic_equivalent_taps(8, 4, 1)
    ff, jf = FusedFrontend2(h, 8), JFused(h, 8, interpret=True)
    C = 3
    words = torch.from_numpy(freq_word(np.linspace(-10e3, 10e3, C), 192e3))
    st_t, st_j = ff.init_state(C), jf.init_state(C)
    step = jax.jit(jf.step)
    for _ in range(2):
        x = (rng.standard_normal((C, 4096)) + 1j * rng.standard_normal((C, 4096)))
        iq = torch.from_numpy(x.astype(np.complex64))
        v = torch.view_as_real(iq)
        p = _plan(ff, v[..., 0], v[..., 1], C, chunk=512)
        y_e, _ = fp.execute(p, ff.w1, ff.w2, v[..., 0], v[..., 1], st_t["tail"], st_t["acc"],
                            words)
        st_j, y_j = step(st_j, jnp.asarray(x.astype(np.complex64)), jnp.asarray(words.numpy()))
        np.testing.assert_allclose(y_e.numpy(), np.asarray(y_j), atol=5e-6)
        st_t = ff.next_state(st_t, v[..., 0], v[..., 1], words)
