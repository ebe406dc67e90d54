"""The port's stage-pipelined executor (``radioframe_torch/shard/pipeline.py``)
against the JAX PipelinedRx and against the port's own sequential
``RxChain.step`` (ported from tests/test_pipeline.py, at its ``_cfg()``).

The JAX pipeline runs on two of the conftest's fake CPU devices, the port's
on the CPU. Tolerances are tests/test_pipeline.py's: audio 2e-4 after the
first block's WARMUP = 512 samples (the mode filter's cold-start partial
convolution under max AGC gain magnifies ulps), every state leaf 2e-4,
``power_in`` rtol 1e-6. The panorama's dB lines (the ``spectrum`` aux and
the ``spec`` state) are held as tests/test_torch_spectrum.py holds them
across the two packages, 1e-2 dB over the 60 dB below each line's peak:
the two packages' FFTs round differently, and a low bin's relative error
is large in dB (2e-4 is the JAX pipeline against the JAX chain, the same
FFT on both sides). Against the port's sequential
step the pipeline is the same operations in the same order on the CPU:
bit-equal, audio, aux and state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core import config as jcfg
from radioframe.pipelines.rx_chain import RxChain as JChain
from radioframe.shard.pipeline import PipelinedRx as JPipelinedRx
from radioframe_torch.convert import state_to_numpy
from radioframe_torch.core import config as tcfg
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.rx_chain import RxChain as TChain
from radioframe_torch.shard.pipeline import PipelinedRx

torch.set_num_threads(2)

WARMUP = 512  # == ModeFilters.numtaps - 1 at fs_audio
TOL = dict(atol=2e-4, rtol=1e-5)


def _cfg(mod, **kw):
    return mod.RxConfig(fs_in=192_000.0, channels=4,
                        stages=(mod.CicStage(R=2, N=3),
                                mod.FirStage(R=2, numtaps=33, passband_hz=15_000.0)),
                        ols_hop=256, fuse_frontend=False, emit_spectrum=True, **kw)


def _inputs(n_blocks: int, T: int, freqs, modes):
    rng = np.random.default_rng(5)
    blocks = [(rng.standard_normal((4, T)) + 1j * rng.standard_normal((4, T)))
              .astype(np.complex64) for _ in range(n_blocks)]
    return blocks, freq_word(np.asarray(freqs), 192_000.0), np.asarray(modes, np.int32)


def _jax_pipeline(blocks, words, modes):
    chain = JChain(_cfg(jcfg))
    devs = jax.devices()
    assert len(devs) >= 2, "the conftest's CPU mesh exposes 8 devices"
    pipe = JPipelinedRx(chain, devs[0], devs[1])
    f, b = pipe.init_states(4)
    f, b, audios, auxes = pipe.run(f, b, [jnp.asarray(x) for x in blocks], jnp.asarray(words),
                                   jnp.asarray(modes))
    return f, b, [np.asarray(a) for a in audios], auxes


def _port_pipeline(blocks, words, modes, **kw):
    chain = TChain(_cfg(tcfg, **kw))
    pipe = PipelinedRx(chain, "cpu", "cpu")
    f, b = pipe.init_states(4)
    return chain, pipe.run(f, b, [torch.from_numpy(x) for x in blocks],
                           torch.from_numpy(words), torch.from_numpy(modes))


def _lines_close(db_t, db_j, span_db=60.0):
    """dB lines within 1e-2 over the span_db below each line's peak
    (tests/test_torch_spectrum.py's bound)."""
    db_t, db_j = np.asarray(db_t), np.asarray(db_j)
    shown = db_j >= db_j.max(axis=-1, keepdims=True) - span_db
    assert shown.mean() > 0.3
    np.testing.assert_allclose(db_t[shown], db_j[shown], atol=1e-2)


def _state_close(got, want):
    """The port's state tree against the JAX one, leaf by leaf."""
    assert set(got) == set(want)
    for k in want:
        if k == "spec":
            _lines_close(got[k], want[k])
            continue
        g, w = jax.tree.leaves(got[k]), jax.tree.leaves(want[k])
        assert len(g) == len(w), k
        for a, b in zip(g, w):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL, err_msg=k)


def test_pipelined_matches_jax_pipeline():
    T = 4 * TChain(_cfg(tcfg)).min_block
    blocks, words, modes = _inputs(3, T, np.linspace(-20e3, 20e3, 4), [0, 1, 2, 3])
    jf, jb, jaudio, _ = _jax_pipeline(blocks, words, modes)
    _, (tf, tb, taudio, _) = _port_pipeline(blocks, words, modes)
    assert len(taudio) == len(jaudio) == 3
    for b, (got, want) in enumerate(zip(taudio, jaudio)):
        skip = WARMUP if b == 0 else 0
        np.testing.assert_allclose(got.numpy()[:, skip:], want[:, skip:], **TOL)
    for j_tree, t_tree in ((jf, tf), (jb, tb)):
        _state_close(state_to_numpy(t_tree), jax.tree.map(np.asarray, j_tree))


def test_pipelined_aux_matches_jax():
    T = 2 * TChain(_cfg(tcfg)).min_block
    blocks, words, modes = _inputs(1, T, np.full(4, 7e3), np.zeros(4))
    _, _, _, jaux = _jax_pipeline(blocks, words, modes)
    _, (_, _, _, taux) = _port_pipeline(blocks, words, modes)
    np.testing.assert_allclose(taux[0]["power_in"].numpy(), np.asarray(jaux[0]["power_in"]),
                               rtol=1e-6)
    _lines_close(taux[0]["spectrum"].numpy(), np.asarray(jaux[0]["spectrum"]))


@pytest.mark.parametrize("kw", [{}, dict(nb_enabled=True, nr_enabled=True, vad_enabled=True)],
                         ids=["dense", "options"])
def test_pipelined_bit_equal_to_sequential_step(kw):
    """On the CPU the two stages are RxChain.step's own operations: audio,
    aux and state bit-equal, the front state's keys on the front stage and
    the back state's on the back."""
    T = 4 * TChain(_cfg(tcfg, **kw)).min_block
    blocks, words, modes = _inputs(4, T, np.linspace(-30e3, 30e3, 4), [0, 1, 2, 3])
    chain, (f, b, audios, auxes) = _port_pipeline(blocks, words, modes, **kw)
    state = chain.init_state(4)
    w, m = torch.from_numpy(words), torch.from_numpy(modes)
    for x, a, aux in zip(blocks, audios, auxes):
        with torch.no_grad():
            state, a_ref, aux_ref = chain.step(state, torch.from_numpy(x), w, m)
        assert torch.equal(a, a_ref)
        assert set(aux) == set(aux_ref)
        assert all(torch.equal(aux[k], aux_ref[k]) for k in aux)
    f_ref, b_ref = chain.split_state(state)
    assert set(f) == set(chain.FRONT_KEYS) and not set(b) & set(chain.FRONT_KEYS)
    for got, want in ((f, f_ref), (b, b_ref)):
        g, r = jax.tree.leaves(state_to_numpy(got)), jax.tree.leaves(state_to_numpy(want))
        assert len(g) == len(r) and all(np.array_equal(x, y) for x, y in zip(g, r))


def test_pipeline_devices_default_to_the_chain():
    chain = TChain(_cfg(tcfg))
    pipe = PipelinedRx(chain)
    assert pipe.dev_front == pipe.dev_back == torch.device("cpu")
    f, b = pipe.init_states(4)
    _, _, audios, _ = pipe.run(f, b, [], torch.zeros(4, dtype=torch.int32),
                               torch.zeros(4, dtype=torch.int32))
    assert audios == []
    with pytest.raises(ValueError, match="unsupported device"):
        PipelinedRx(chain, "meta")
