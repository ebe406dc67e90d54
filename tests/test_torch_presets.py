"""The ADC-rate preset (presets.adc_61m44: 61.44 Msps -> 48 kHz, CIC(32)
-> FIR(8) -> FIR(5), R=1280): the port's RxChain and ShardedRxChain against
the JAX package's, ported from tests/test_presets.py.

Two front ends of the port: the preset as it is (the dense mix and
decimators) and the fused depth-2 front end, which is K1 at (R1, R2) =
(32, 8) (its plain route on the CPU). The JAX side runs the preset as the
reference's own tests do.

Tolerances, the reference's: the tone's SNR above 30 dB (and, BASELINE's
bar, within 1 dB of the JAX chain's); audio 5e-4 after the first 64 samples
(the sharded test's bound), here also against the JAX chain."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.core import presets as jpresets
from radioframe.diag.metrics import audio_snr_db
from radioframe.ops import demod as jdemod
from radioframe.ops import nco as jnco
from radioframe.pipelines.rx_chain import RxChain as JRxChain
from radioframe.shard.rx import ShardedRxChain as JShardedRx
from radioframe_torch.core import presets
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.rx_chain import RxChain
from radioframe_torch.shard.mesh import spawn

torch.set_num_threads(2)

FRONT_ENDS = {"dense": {}, "k1 32x8": dict(fuse_frontend=True, fuse_frontend_depth=2)}
SKIP = 64  # the sharded test's settling samples
RANKS_TIMEOUT_S = 240.0
SHARD_MESH = (1, 4)
SHARD_FREQ = 5_000_000.0


def _port_cfg(front_end: str, channels: int):
    return presets.adc_61m44(channels=channels, **FRONT_ENDS[front_end])


def _port_run(cfg, blocks, freqs, modes):
    chain = RxChain(cfg)
    st, out = chain.init_state(), []
    with torch.no_grad():
        for b in blocks:
            st, a, _ = chain.step(st, torch.from_numpy(b),
                                  torch.from_numpy(nco.freq_word(freqs, cfg.fs_in)),
                                  torch.from_numpy(np.asarray(modes, np.int32)))
            out.append(a.numpy())
    return out


@pytest.mark.parametrize("front_end", list(FRONT_ENDS))
def test_adc_rate_ddc_ssb(front_end):
    """A 1 kHz tone as USB at a +12.345 MHz carrier offset, one block at the
    ADC rate."""
    cfg = _port_cfg(front_end, 1)
    chain = RxChain(cfg)
    assert cfg.decim == 1280 and cfg.fs_audio == 48_000.0
    if front_end != "dense":
        assert chain.fused_stages == 2 and (chain.fused.R, chain.fused.R2) == (32, 8)
    fs, T = cfg.fs_in, chain.min_block
    t = np.arange(T) / fs
    tone = np.exp(2j * np.pi * (12_345_000.0 + 1000.0) * t).astype(np.complex64)[None, :]
    audio = _port_run(cfg, [tone], np.array([12_345_000.0]), [0])[0][0]

    jchain = JRxChain(jpresets.adc_61m44(channels=1))
    _, ja, _ = jax.jit(jchain.step)(jchain.init_state(1), jnp.asarray(tone),
                                    jnp.asarray([jnco.freq_word(12_345_000.0, fs)], jnp.int32),
                                    jnp.asarray([jdemod.SSB], jnp.int32))
    ja = np.asarray(ja)[0]
    ref = np.cos(2 * np.pi * 1000.0 * np.arange(len(audio)) / 48_000.0)
    snr = audio_snr_db(ref, audio, trim=len(audio) // 8)
    snr_jax = audio_snr_db(ref, ja, trim=len(ja) // 8)
    assert snr > 30.0, f"ADC-rate DDC tone SNR {snr:.1f} dB"
    assert abs(snr - snr_jax) <= 1.0, (snr, snr_jax)
    np.testing.assert_allclose(audio[SKIP:], ja[SKIP:], atol=5e-4)


def test_wideband_preset_builds():
    chain = RxChain(presets.wideband_1536k(channels=8))
    assert chain.cfg.decim == 32 and chain.cfg.fs_audio == 48_000.0


def _shard_block():
    cfg = presets.adc_61m44(channels=2)
    T = SHARD_MESH[1] * RxChain(cfg).min_block
    t = np.arange(T) / cfg.fs_in
    tone = np.exp(2j * np.pi * (SHARD_FREQ + 700.0) * t).astype(np.complex64)
    return np.stack([tone, 0.5 * tone])


SHARD_IQ = _shard_block()
SHARD_FREQS = np.full(2, SHARD_FREQ)
SHARD_MODES = np.zeros(2, np.int32)  # SSB


def _port_sharded():
    import torch_shard_ranks  # tests/ is on the path; the ranks import it too

    cases = {SHARD_MESH: [(name, {f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
                          for name, cfg in ((n, _port_cfg(n, 2)) for n in FRONT_ENDS)]}
    return spawn(torch_shard_ranks.chain_cases, 4, [SHARD_MESH], cases, [SHARD_IQ],
                 SHARD_FREQS, SHARD_MODES, timeout_s=RANKS_TIMEOUT_S)[0][SHARD_MESH]


def _jax_sharded():
    chain = JRxChain(jpresets.adc_61m44(channels=2))
    mesh = jax.make_mesh(SHARD_MESH, ("channel", "time"), devices=jax.devices()[:4])
    words = jnp.asarray(jnco.freq_word(SHARD_FREQS, chain.cfg.fs_in))
    _, got, _ = jax.jit(JShardedRx(chain, mesh).step)(chain.init_state(2),
                                                      jnp.asarray(SHARD_IQ), words,
                                                      jnp.asarray(SHARD_MODES))
    return np.asarray(got)


@pytest.fixture(scope="module")
def sharded():
    """(port sharded by front end, port unsharded by front end, JAX
    sharded): the ranks run while this process computes the references."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_port_sharded)
        ref = {n: _port_run(_port_cfg(n, 2), [SHARD_IQ], SHARD_FREQS, SHARD_MODES)[0]
               for n in FRONT_ENDS}
        jref = _jax_sharded()
        return fut.result(), ref, jref


@pytest.mark.parametrize("front_end", list(FRONT_ENDS))
def test_adc_rate_sharded_matches_unsharded(sharded, front_end):
    """R=1280 under time sharding on (1, 4): halos at three rates."""
    got = sharded[0][front_end]["audio"][0]
    assert got.shape == (2, SHARD_IQ.shape[-1] // 1280) and np.isfinite(got).all()
    np.testing.assert_allclose(got[:, SKIP:], sharded[1][front_end][:, SKIP:], atol=5e-4)
    np.testing.assert_allclose(got[:, SKIP:], sharded[2][:, SKIP:], atol=5e-4)
