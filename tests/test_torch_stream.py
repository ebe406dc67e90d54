"""The runtime: core/stream.py (BlockStream, Stager, wav_blocks,
synthetic_blocks), io/wav.py and diag/timing.py of the port, against the
JAX package's BlockStream and the port's own one-shot step.

Tolerances: the port's BlockStream against the JAX BlockStream 1e-3 (the
whole-chain bound) after block 0 (whose cold-start AGC gain magnifies
ulps); the stream against one block over the same samples
2e-5 after the first 512 audio samples (tests/test_stream_cli.py's bound:
the OLS bank's block edge rounds differently); the CPU stream against a
plain loop of the step bit-equal (no copy can change a value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core import config as jcfg
from radioframe.core.stream import BlockStream as JBlockStream
from radioframe.pipelines.rx_chain import RxChain as JRxChain
from radioframe_torch.core.config import RxConfig
from radioframe_torch.core.stream import BlockStream, Stager, synthetic_blocks, wav_blocks
from radioframe_torch.diag.timing import StageTimer, sync_value
from radioframe_torch.io import fixtures as FX
from radioframe_torch.io.wav import read_wav, write_wav
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.rx_chain import RxChain

torch.set_num_threads(2)

FS = 192_000.0
C, BLOCKS = 2, 8
FREQS = np.array([37_000.0, -15_000.0])
MODES = np.array([demod_op.SSB, demod_op.AM], np.int32)


def _blocks(chain):
    n = BLOCKS * chain.min_block
    iq = FX.ssb_capture(FS, n, 37_000.0)[0] + FX.am_capture(FS, n, -15_000.0)[0]
    wide = np.broadcast_to(iq.astype(np.complex64), (C, n))
    return [np.ascontiguousarray(b) for b in np.split(wide, BLOCKS, axis=-1)]


def _port_stream(chain, blocks):
    bs = BlockStream(chain.step, chain.init_state(C), device="cpu")
    words = torch.from_numpy(nco.freq_word(FREQS, FS))
    outs, auxs = bs.run(iter(blocks), words, torch.from_numpy(MODES))
    return bs, outs, auxs


def test_block_stream_matches_jax_block_stream():
    chain = RxChain(RxConfig(channels=C))
    blocks = _blocks(chain)
    _, outs, auxs = _port_stream(chain, blocks)
    jchain = JRxChain(jcfg.RxConfig(channels=C))
    jbs = JBlockStream(jchain.step, jax.jit(lambda: jchain.init_state(C))(), donate=False)
    jouts, _ = jbs.run(iter(blocks), jnp.asarray(nco.freq_word(FREQS, FS)), jnp.asarray(MODES))
    assert len(outs) == len(jouts) == BLOCKS and len(auxs) == BLOCKS
    got = np.concatenate([o.numpy() for o in outs], axis=-1)
    want = np.concatenate([np.asarray(o) for o in jouts], axis=-1)
    Ta = outs[0].shape[-1]  # block 0 carries the cold-start AGC transient
    np.testing.assert_allclose(got[:, Ta:], want[:, Ta:], atol=1e-3)


def test_stream_equals_oneshot_and_loop():
    chain = RxChain(RxConfig(channels=C))
    blocks = _blocks(chain)
    bs, outs, _ = _port_stream(chain, blocks)
    words = torch.from_numpy(nco.freq_word(FREQS, FS))
    modes = torch.from_numpy(MODES)
    with torch.no_grad():
        _, whole, _ = chain.step(chain.init_state(C),
                                 torch.from_numpy(np.concatenate(blocks, axis=-1)), words, modes)
        st, loop = chain.init_state(C), []
        for b in blocks:
            st, a, _ = chain.step(st, torch.from_numpy(b), words, modes)
            loop.append(a)
    got = torch.cat(outs, dim=-1)
    assert torch.equal(got, torch.cat(loop, dim=-1))
    assert torch.equal(bs.state["nco"], st["nco"])
    np.testing.assert_allclose(got[0, 512:].numpy(), whole[0, 512:].numpy(), atol=2e-5)


def test_block_stream_tuple_blocks_and_empty_source():
    """A tuple block (the int16 planes) reaches the step as one tuple of
    tensors; an empty source returns no outputs."""
    seen = []

    def step(state, block, k):
        seen.append(tuple(t.dtype for t in block))
        xr, xi = block
        return state + k, (xr.to(torch.float32) + xi).sum(), None

    bs = BlockStream(step, 0, device="cpu")
    src = synthetic_blocks(lambda rng, c, n: tuple(rng.integers(-9, 9, (c, n), dtype=np.int16)
                                                   for _ in range(2)), 16, 3, channels=2)
    outs, auxs = bs.run(src, 1)
    assert bs.state == 3 and len(outs) == 3 and auxs == [None] * 3
    assert seen == [(torch.int16, torch.int16)] * 3
    assert bs.run(iter([]), 1) == ([], [])


def test_stager_cpu_keeps_values_and_casts():
    st = Stager("cpu")
    x = np.arange(6, dtype=np.complex128).reshape(2, 3)
    t = st.to_device(x, np.complex64)
    assert t.dtype == torch.complex64 and np.array_equal(t.numpy(), x.astype(np.complex64))
    ro = np.broadcast_to(np.ones(4, np.float32), (2, 4))  # read-only view
    assert st.to_device(ro).numpy().flags.writeable
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Stager("cuda")


def test_wav_blocks_padding(tmp_path):
    rng = np.random.default_rng(4)
    iq = (0.5 * (rng.standard_normal(1000) + 1j * rng.standard_normal(1000))).astype(np.complex64)
    p = str(tmp_path / "cap.wav")
    write_wav(p, iq, FS, scale=1.0)
    back, fs = read_wav(p)
    blocks = list(wav_blocks(p, 384))
    assert fs == FS and len(blocks) == 3
    assert all(b.shape == (1, 384) and b.dtype == np.complex64 for b in blocks)
    cat = np.concatenate([b[0] for b in blocks])
    assert np.array_equal(cat[:1000], back) and not cat[1000:].any()


def test_synthetic_blocks_deterministic():
    gen = lambda rng, c, n: rng.standard_normal((c, n)).astype(np.float32)  # noqa: E731
    a = list(synthetic_blocks(gen, 32, 3, channels=2, seed=5))
    b = list(synthetic_blocks(gen, 32, 3, channels=2, seed=5))
    assert len(a) == 3 and all(np.array_equal(x, y) and x.shape == (2, 32) for x, y in zip(a, b))


def test_stage_timer():
    t = StageTimer("cpu")
    x = torch.ones((128, 128))
    with t.stage("mul", sync_on=x * 2):
        y = x * 2
    with t.stage("mul"):
        pass
    rep = t.report()
    assert "mul" in rep and "x2" in rep and t.counts["mul"] == 2 and t.totals["mul"] > 0.0
    assert sync_value(y) == 2 * 128 * 128
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StageTimer("cuda")
