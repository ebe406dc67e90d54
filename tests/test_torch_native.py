"""The port's native IQ transport (radioframe_torch.native) against the
JAX package's (radioframe.native) on the same int16 input, byte for byte,
and CaptureSource's ring semantics on it: the ring round trip, overflow
refusal, a threaded producer, the overrun count and the int16 route."""

import threading
import time

import numpy as np
import pytest
import torch

import radioframe.native as jnative
import radioframe_torch.native as tnative
from radioframe_torch.core.config import RxConfig
from radioframe_torch.core.stream import BlockStream, CaptureSource
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.rx_chain import RxChain

torch.set_num_threads(2)


def test_native_built_outside_the_package():
    assert tnative.HAVE_NATIVE
    so = tnative._build()
    assert so.parent == tnative.BUILD_DIR and so.parent.parts[-2:] == ("build", "native")
    assert not list(tnative.SRC.parent.glob("*.so"))


@pytest.mark.parametrize("fn,args", [
    ("iq_i16_to_c64", ()),
    ("iq_i16_to_c64", (1.0 / 2048.0,)),
    ("iq_i16_deinterleave", ()),
])
def test_conversions_byte_equal_to_reference(rng, fn, args):
    pcm = rng.integers(-32768, 32767, 4096, dtype=np.int16)
    got, want = getattr(tnative, fn)(pcm, *args), getattr(jnative, fn)(pcm, *args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_c64_to_i16_byte_equal_and_saturates(rng):
    iq = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    iq[0] = 10.0 + 10.0j  # overdrive
    out = tnative.c64_to_iq_i16(iq)
    assert out[0] == 32767 and out[1] == 32767
    assert out.tobytes() == jnative.c64_to_iq_i16(iq).tobytes()


def test_odd_word_count_refused():
    with pytest.raises(ValueError, match="even number"):
        tnative.iq_i16_to_c64(np.zeros(3, np.int16))


def test_ringbuffer_roundtrip(rng):
    rb = tnative.RingBuffer(1 << 16)
    x = (rng.standard_normal(1024) + 1j * rng.standard_normal(1024)).astype(np.complex64)
    assert rb.write(x)
    assert rb.fill == x.nbytes
    np.testing.assert_array_equal(rb.read(x.nbytes), x)
    assert rb.read(8) is None  # empty
    rb.close()


def test_ringbuffer_rejects_overflow():
    rb = tnative.RingBuffer(1 << 12)  # 4 KiB
    assert not rb.write(np.zeros(1024, np.complex64))  # 8 KiB
    assert rb.fill == 0


def test_ringbuffer_threaded_stream(rng):
    """A producer thread (the interrupt) feeds blocks; the consumer drains
    them in order."""
    rb = tnative.RingBuffer(1 << 18)
    blocks = [(rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
              for _ in range(64)]

    def producer():
        for b in blocks:
            while not rb.write(b):
                time.sleep(0)

    t = threading.Thread(target=producer)
    t.start()
    got, t0 = [], time.monotonic()
    while len(got) < 64 and time.monotonic() - t0 < 30.0:
        y = rb.read(512 * 8)
        if y is not None:
            got.append(y)
    t.join(timeout=10.0)
    assert not t.is_alive()
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(blocks))


def _pcm_chunks(n_chunks, chunk_complex, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-2000, 2000, 2 * chunk_complex, dtype=np.int16) for _ in range(n_chunks)]


def test_capture_blocks_match_direct_conversion():
    chunks = _pcm_chunks(8, 1024)
    src = CaptureSource(iter(chunks), block_len=512)
    got = np.concatenate([b[0] for b in src])
    want = np.concatenate([jnative.iq_i16_to_c64(c) for c in chunks])
    assert len(got) == 8 * 1024 and got.tobytes() == want.tobytes()
    assert src.overruns == 0


def test_overrun_counted_when_consumer_stalls():
    src = CaptureSource(iter(_pcm_chunks(32, 1024)), block_len=1024, capacity_blocks=2,
                        overrun_wait_s=0.001, overrun_retries=3)
    src.start()
    t0 = time.monotonic()
    while src.overruns == 0 and time.monotonic() - t0 < 10.0:
        time.sleep(0.01)  # never consume: the two-block ring must overrun
    assert src.overruns > 0
    assert sum(1 for _ in src) >= 2  # the stream stays usable: drain what got through


def test_capture_drives_rx_chain_identically():
    """BlockStream(CaptureSource) equals feeding the same blocks directly."""
    chain = RxChain(RxConfig(channels=1, ols_hop=512))
    T = chain.min_block
    chunks = _pcm_chunks(4, T, seed=3)
    words = torch.from_numpy(nco.freq_word(np.array([10e3]), 192e3))
    mode = torch.tensor([demod_op.SSB], dtype=torch.int32)
    bs = BlockStream(chain.step, chain.init_state(1), device="cpu")
    outs, _ = bs.run(CaptureSource(iter(chunks), block_len=T), words, mode)
    st, ref = chain.init_state(1), []
    with torch.no_grad():
        for c in chunks:
            st, a, _ = chain.step(st, torch.from_numpy(tnative.iq_i16_to_c64(c)[None, :]),
                                  words, mode)
            ref.append(a)
    assert torch.equal(torch.cat(outs, dim=-1), torch.cat(ref, dim=-1))


def test_capture_source_raw_i16(rng):
    """raw_i16: the ring carries interleaved int16 and the iterator yields
    (xr, xi) plane blocks equal to the words; a custom scale is refused."""
    pcms = [(rng.standard_normal(2 * 1024) * 8192).astype(np.int16) for _ in range(6)]
    src = CaptureSource(iter(pcms), block_len=1536, raw_i16=True)
    blocks = list(src)
    assert len(blocks) == 6 * 1024 // 1536
    allpcm = np.concatenate(pcms)
    got_r = np.concatenate([b[0][0] for b in blocks])
    got_i = np.concatenate([b[1][0] for b in blocks])
    np.testing.assert_array_equal(got_r, allpcm[0::2][: got_r.size])
    np.testing.assert_array_equal(got_i, allpcm[1::2][: got_i.size])
    assert src.overruns == 0
    with pytest.raises(ValueError, match="ignores CaptureSource scale"):
        CaptureSource(iter(pcms), block_len=1536, raw_i16=True, scale=1.0 / 2048.0)


def test_raw_i16_drives_step_i16():
    """CaptureSource(raw_i16) -> BlockStream -> step_i16 (K1's int16 route,
    its plain version here) equals step_i16 on the same words."""
    cfg = RxConfig(channels=1, fuse_frontend=True, fuse_frontend_depth=2, int16_ingest=True)
    chain = RxChain(cfg)
    T = chain.min_block
    chunks = _pcm_chunks(3, T, seed=9)
    words = torch.from_numpy(nco.freq_word(np.array([10e3]), 192e3))
    mode = torch.tensor([demod_op.SSB], dtype=torch.int32)
    step = lambda st, b, w, m: chain.step_i16(st, b[0], b[1], w, m)  # noqa: E731
    src = CaptureSource(iter(chunks), block_len=T, raw_i16=True)
    outs, _ = BlockStream(step, chain.init_state(1), device="cpu").run(src, words, mode)
    st, ref = chain.init_state(1), []
    with torch.no_grad():
        for c in chunks:
            xr, xi = tnative.iq_i16_deinterleave(c)
            st, a, _ = chain.step_i16(st, torch.from_numpy(xr[None]), torch.from_numpy(xi[None]),
                                      words, mode)
            ref.append(a)
    assert len(outs) == 3 and src.overruns == 0
    assert torch.equal(torch.cat(outs, dim=-1), torch.cat(ref, dim=-1))
