"""Config 4 over a mesh and the RX options across shards: the port's
sharded_biquad_cascade, ShardedTxChain, ShardedRxChain with the options and
ShardedDuplex, each against the port's unsharded chain, and ShardedTxChain
against the JAX ShardedTxChain.

The port runs as four spawned gloo ranks on the CPU, one ``spawn`` for
every case (``tests/torch_shard_ranks.tx_cases``), on meshes (1, 4) and
(2, 2); the unsharded chains and the JAX references run in this process
meanwhile. C=8 channels, two streamed blocks.

Tolerances, the reference's own (tests/test_sharded_tx.py,
tests/test_sharded.py): TX IQ 5e-4 on unit-scale IQ; the FM phase as
phasors 2e-3; the interpolators' tails, which are modulator output, to the
IQ bound (an NFM tail carries the phase integrator's reassociation);
RX audio 2e-4 after block 0 (block 0 carries the cold-start AGC, NR and VAD
transients), NFM rows modulo fs/deviation = 19.2; VAD flags equal; the
option states rtol 1e-4 (the notch EMA takes its frame mean as a psum of
the shards' sums, not one mean); biquad outputs and
carries 1e-4 against the unsharded cascade (the bound of
tests/test_biquad.py's sharded mic-EQ state).

R4: the reference's ShardedTxChain stacks four modulator branches, so an
LSB channel (mode 4) reads past the stack and sends NaN. The port's sends
the LSB signal of the unsharded chain (test_sharded_lsb_channel_r4).

F3: run free over blocks, the sharded and unsharded float32 FM phase
integrators drift apart (their prefix sums round in different orders, and
the difference is carried). test_fm_phase_drift_rate_matches_jax measures
the drift rate of both packages on the same input and holds the port's to
the reference's within 2x and to FM_DRIFT_PER_BLOCK."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

from radioframe.core import config as jcfg
from radioframe.pipelines.tx_chain import TxChain as JTx
from radioframe.shard.mesh import place_state
from radioframe.shard.tx import ShardedTxChain as JShardedTx
from radioframe_torch.core import config as tcfg
from radioframe_torch.io.fixtures import voicelike_audio
from radioframe_torch.ops import filter_design as FD
from radioframe_torch.ops.biquad import BiquadCascade
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.pipelines.duplex import DuplexChain
from radioframe_torch.pipelines.rx_chain import RxChain
from radioframe_torch.pipelines.tx_chain import TxChain
from radioframe_torch.shard.mesh import P, spawn

torch.set_num_threads(2)

C, BLOCKS, FS = 8, 2, 1_536_000.0
T = 65536           # 4 x the options chain's min_block: T_local >= min_block on 4 shards
TA = T // 32        # the TX audio block of the same air time
NFM_PERIOD = 19.2   # fs_audio / deviation: an atan2 branch flip
RANKS_TIMEOUT_S = 240.0
MESHES = [(1, 4), (2, 2)]
EQ = ((300.0, 3.0, 1.0), (2500.0, 6.0, 2.0))
OPTIONS = dict(nb_enabled=True, nr_enabled=True, notch_enabled=True, vad_enabled=True,
               nfm_deemphasis_s=531e-6, squelch_enabled=True)
RX_MODES = (np.arange(C) % 4).astype(np.int32)  # SSB, CW, AM, NFM
TX_MODES = (np.arange(C) % 5).astype(np.int32)  # every branch, LSB at channel 4
RX_FREQS = np.linspace(-5e5, 5e5, C)
TX_FREQS = np.linspace(-6e5, 6e5, C)


def _rx_cfg(mod, **kw):
    return mod.RxConfig(fs_in=FS, channels=C,
                        stages=(mod.CicStage(R=8, N=4),
                                mod.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                        ols_hop=512, enabled_modes=(0, 1, 2, 3), **kw)


def _tx_cfg(mod):
    return mod.TxConfig(fs_out=FS, channels=C, interp_stages=(4, mod.CicStage(R=8, N=4)),
                        mic_eq_bands=EQ)


RX_CASES = {
    # K1's plain route at depth 2, every option
    "rx options": _rx_cfg(tcfg, fuse_frontend=True, fuse_frontend_depth=2, **OPTIONS),
    # the dense front end; NR without the VAD (its estimate over every frame)
    "rx nb nr notch": _rx_cfg(tcfg, nb_enabled=True, nr_enabled=True, notch_enabled=True),
}
# the duplex's RX side: K2 at depth 1 with the rdma transport (K7's plain route here)
DUPLEX_RX = _rx_cfg(tcfg, fuse_frontend=True, fuse_frontend_depth=1, halo_transport="rdma",
                    **OPTIONS)
# F3: the FM phase drift, run free over DRIFT_BLOCKS blocks of the card's
# duplex audio block (T_FLAG // 32 = 4096 samples) with the mic EQ
DRIFT_BLOCKS, DRIFT_TA = 8, 4096
DRIFT_JAX_MESH = (2, 4)  # the 8 fake devices; the time split of the port's (1, 4)
# rad a block, as phasors: the largest drift over C channels after k blocks is
# at most k times this. Both packages: ~2e-4 after the first block at C=8, a
# random walk after it; the largest of C channels grows like sqrt(2 ln C), so
# ~3e-4 at the card's C=128 (chip_smoke.py's sharded-duplex phase, which holds
# its free run to the same bound)
FM_DRIFT_PER_BLOCK = 5e-4
SOS = np.concatenate([FD.peaking_eq_sos(EQ, 48_000.0), FD.deemphasis_sos(531e-6, 48_000.0),
                      signal.butter(2, 0.2, output="sos")])


def _inputs():
    rng = np.random.default_rng(21)
    iq = []
    for b in range(BLOCKS):
        x = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
        n = b * T + np.arange(T)
        for ch in np.flatnonzero(RX_MODES == 3):  # a carrier in each NFM channel
            x[ch] += 4.0 * np.exp(2j * np.pi * RX_FREQS[ch] * n / FS).astype(np.complex64)
        iq.append(x)
    speech = np.stack([voicelike_audio(48_000.0, BLOCKS * TA, seed=i) for i in range(C)])
    audio = np.split(speech.astype(np.float32), BLOCKS, axis=-1)
    bq = [rng.standard_normal((C, TA)).astype(np.float32) for _ in range(BLOCKS)]
    return iq, audio, bq


IQ, AUDIO, BQ_X = _inputs()
DRIFT_AUDIO = np.split(np.stack([voicelike_audio(48_000.0, DRIFT_BLOCKS * DRIFT_TA, seed=40 + i)
                                 for i in range(C)]).astype(np.float32), DRIFT_BLOCKS, axis=-1)
RX_WORDS, TX_WORDS = freq_word(RX_FREQS, FS), freq_word(TX_FREQS, FS)


def _cases():
    out = []
    for m in MESHES:
        out.append(("biquad", m, "biquad", (SOS, BQ_X)))
        out.append(("tx", m, "tx", (_tx_cfg(tcfg), AUDIO, TX_WORDS, TX_MODES)))
        for name, cfg in RX_CASES.items():
            out.append((name, m, "rx", (cfg, IQ, RX_WORDS, RX_MODES)))
        out.append(("duplex", m, "duplex", (DUPLEX_RX, _tx_cfg(tcfg), IQ, AUDIO, RX_WORDS,
                                            RX_MODES, TX_WORDS, TX_MODES)))
    out.append(("radio", (2, 2), "radio", (RX_CASES["rx options"], IQ, RX_FREQS, RX_MODES)))
    out.append(("tx drift", (1, 4), "tx_drift", (_tx_cfg(tcfg), DRIFT_AUDIO, TX_WORDS, TX_MODES)))
    return [((name, m), m, kind, args) for name, m, kind, args in out]


def _port_all():
    import torch_shard_ranks  # tests/ is on the path; the ranks import it too

    return spawn(torch_shard_ranks.tx_cases, 4, _cases(), timeout_s=RANKS_TIMEOUT_S)[0]


def _unsharded():
    """The port's unsharded chains on the same blocks: {name: {"out",
    "vad", "state"}} in the ranks' layout."""
    ref = {}
    with torch.no_grad():
        casc = BiquadCascade(SOS)
        st, ys = casc.init_state(C), []
        for x in BQ_X:
            y, st = casc(st, torch.from_numpy(x))
            ys.append([y.numpy()])
        ref["biquad"] = {"out": ys, "state": tuple(s.numpy() for s in st)}
        tx = TxChain(_tx_cfg(tcfg))
        ref["tx"] = _run(tx.init_state(), [(torch.from_numpy(a),) for a in AUDIO],
                         lambda s, a: tx.step(s, a, torch.from_numpy(TX_WORDS),
                                              torch.from_numpy(TX_MODES)))
        for name, cfg in RX_CASES.items():
            rx = RxChain(cfg)
            ref[name] = _run(rx.init_state(), [(torch.from_numpy(x),) for x in IQ],
                             lambda s, x, rx=rx: rx.step(s, x, torch.from_numpy(RX_WORDS),
                                                         torch.from_numpy(RX_MODES)))
        dpx = DuplexChain(DUPLEX_RX, _tx_cfg(tcfg))
        ws = [torch.from_numpy(w) for w in (RX_WORDS, RX_MODES, TX_WORDS, TX_MODES)]
        ref["duplex"] = _run(dpx.init_state(), [(torch.from_numpy(x), torch.from_numpy(a))
                                                for x, a in zip(IQ, AUDIO)],
                             lambda s, x, a: dpx.step(s, x, a, *ws))
    return ref


def _run(st, blocks, step):
    from radioframe_torch.convert import state_to_numpy

    res = {"out": [], "vad": []}
    for blk in blocks:
        st, *outs = step(st, *blk)
        res["out"].append([o.numpy() for o in outs if isinstance(o, torch.Tensor)])
        if isinstance(outs[-1], dict) and "vad_active" in outs[-1]:
            res["vad"].append(outs[-1]["vad_active"].numpy())
    res["state"] = state_to_numpy(st)
    return res


def _jax_sharded_tx():
    """The JAX ShardedTxChain on each mesh: {mesh: (iq blocks, state)}."""
    chain = JTx(_tx_cfg(jcfg))
    out = {}
    for m in MESHES:
        mesh = jax.make_mesh(m, ("channel", "time"), devices=jax.devices()[: m[0] * m[1]])
        sh = JShardedTx(chain, mesh)
        st = place_state(chain.init_state(C), sh.state_specs(), mesh)
        step, iqs = jax.jit(sh.step), []
        for a in AUDIO:
            st, iq = step(st, jnp.asarray(a), jnp.asarray(TX_WORDS), jnp.asarray(TX_MODES))
            iqs.append(np.asarray(iq))
        out[m] = (iqs, jax.tree.map(np.asarray, st))
    return out


def _drift_phases():
    """The FM phase after each free-running block over DRIFT_AUDIO: the
    port's unsharded TxChain, the JAX TxChain and the JAX ShardedTxChain on
    DRIFT_JAX_MESH."""
    tx = TxChain(_tx_cfg(tcfg))
    st, port = tx.init_state(), []
    with torch.no_grad():
        for a in DRIFT_AUDIO:
            st, _ = tx.step(st, torch.from_numpy(a), torch.from_numpy(TX_WORDS),
                            torch.from_numpy(TX_MODES))
            port.append(st["fm_phase"].numpy().copy())
    chain = JTx(_tx_cfg(jcfg))
    mesh = jax.make_mesh(DRIFT_JAX_MESH, ("channel", "time"),
                         devices=jax.devices()[: DRIFT_JAX_MESH[0] * DRIFT_JAX_MESH[1]])
    sh = JShardedTx(chain, mesh)
    out = {"port": port}
    for name, step, st in (("jax", jax.jit(chain.step), chain.init_state(C)),
                           ("jax sharded", jax.jit(sh.step),
                            place_state(chain.init_state(C), sh.state_specs(), mesh))):
        out[name] = []
        for a in DRIFT_AUDIO:
            st, _ = step(st, jnp.asarray(a), jnp.asarray(TX_WORDS), jnp.asarray(TX_MODES))
            out[name].append(np.asarray(st["fm_phase"]))
    return out


@pytest.fixture(scope="module")
def results():
    """(port sharded, port unsharded, JAX sharded TX, the free-running FM
    phases of _drift_phases): the ranks run while this process computes the
    references."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_port_all)
        ref = _unsharded()
        jref = _jax_sharded_tx()
        drift = _drift_phases()
        return fut.result(), ref, jref, drift


def _phasor_close(a, b, tol=2e-3):
    assert np.abs(np.exp(1j * a) - np.exp(1j * b)).max() < tol


def _audio_close(got, want):
    d = got - want
    nfm = RX_MODES == 3
    d[nfm] -= NFM_PERIOD * np.round(d[nfm] / NFM_PERIOD)
    np.testing.assert_allclose(d, 0.0, atol=2e-4)


def _tx_state_close(got, want):
    _phasor_close(got["fm_phase"], want["fm_phase"])
    np.testing.assert_array_equal(got["nco"], want["nco"])
    for a, b in zip(got["interp"], want["interp"]):
        np.testing.assert_allclose(a, b, atol=5e-4)
    for a, b in zip(got["eq"], want["eq"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    np.testing.assert_allclose(got["comp"], want["comp"], rtol=1e-5)


def _rx_state_close(got, want):
    np.testing.assert_array_equal(got["nco"], want["nco"])
    for k in ("nb", "nr", "vad", "notch", "squelch"):
        if isinstance(want[k], tuple):
            assert got[k] == ()
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for a, b in zip(got["deemph"], want["deemph"]):
        np.testing.assert_allclose(a, b, atol=2e-4)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_biquad_cascade(results, mesh):
    got, want = results[0][("biquad", mesh)], results[1]["biquad"]
    for g, w in zip(got["out"], want["out"]):
        np.testing.assert_allclose(g[0], w[0], atol=1e-4)
    for g, w in zip(got["state"], want["state"]):
        np.testing.assert_allclose(g, w, atol=1e-4)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_tx_matches_unsharded(results, mesh):
    """Every branch, LSB included, with the mic EQ."""
    got, want = results[0][("tx", mesh)], results[1]["tx"]
    for g, w in zip(got["out"], want["out"]):
        assert g[0].shape == (C, T) and np.isfinite(g[0]).all()
        np.testing.assert_allclose(g[0], w[0], atol=5e-4)
    _tx_state_close(got["state"], want["state"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_tx_matches_jax_sharded(results, mesh):
    """Modes 0-3 (the reference's sharded form has no LSB branch)."""
    got = results[0][("tx", mesh)]
    iqs, st = results[2][mesh]
    rows = TX_MODES < 4
    for g, w in zip(got["out"], iqs):
        np.testing.assert_allclose(g[0][rows], w[rows], atol=5e-4)
    _phasor_close(got["state"]["fm_phase"], st["fm_phase"])
    np.testing.assert_array_equal(got["state"]["nco"], st["nco"])


def test_sharded_lsb_channel_r4(results):
    """R4: an LSB channel of the port's sharded TX is finite and equals the
    unsharded chain's (the reference's sharded TX sends NaN there)."""
    lsb = TX_MODES == 4
    assert lsb.any()
    for mesh in MESHES:
        for g, w in zip(results[0][("tx", mesh)]["out"], results[1]["tx"]["out"]):
            assert np.isfinite(g[0][lsb]).all()
            np.testing.assert_allclose(g[0][lsb], w[0][lsb], atol=5e-4)
    # the unsharded LSB signal is the conjugate mirror of a live SSB one
    assert np.abs(results[1]["tx"]["out"][-1][0][lsb]).max() > 0.1


def _drift(ref, got):
    """The largest FM phase difference as phasors after each block, LSB rows
    left out (R4 makes the reference's sharded LSB output NaN)."""
    rows = TX_MODES != 4
    return np.array([np.abs(np.exp(1j * r[rows]) - np.exp(1j * g[rows])).max()
                     for r, g in zip(ref, got)])


def _rate(d):
    """Drift per block: the least-squares slope through the origin."""
    k = np.arange(1, len(d) + 1)
    return float((k * d).sum() / (k * k).sum())


def test_fm_phase_drift_rate_matches_jax(results):
    """F3: with the mic EQ, run free for DRIFT_BLOCKS blocks, the port's
    ShardedTxChain drifts from its TxChain at the rate the JAX ShardedTxChain
    drifts from the JAX TxChain (within 2x): the drift is float32's, shared
    by both packages, and bounded by FM_DRIFT_PER_BLOCK a block."""
    drift = results[3]
    port = _drift(drift["port"], results[0][("tx drift", (1, 4))]["phases"])
    ref = _drift(drift["jax"], drift["jax sharded"])
    assert port[-1] > 0.0 and ref[-1] > 0.0  # the two integrators do round apart
    ratio = _rate(port) / _rate(ref)
    assert 0.5 <= ratio <= 2.0, (port, ref)
    k = np.arange(1, DRIFT_BLOCKS + 1)
    assert (port <= k * FM_DRIFT_PER_BLOCK).all(), port
    assert (ref <= k * FM_DRIFT_PER_BLOCK).all(), ref


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(RX_CASES))
def test_sharded_rx_options_match_unsharded(results, mesh, case):
    got, want = results[0][(case, mesh)], results[1][case]
    for blk, (g, w) in enumerate(zip(got["out"], want["out"])):
        assert g[0].shape == (C, T // 32) and np.isfinite(g[0]).all()
        if blk > 0:
            _audio_close(g[0], w[0])
    assert len(got["vad"]) == len(want["vad"])
    for g, w in zip(got["vad"], want["vad"]):
        np.testing.assert_array_equal(g, w)
    _rx_state_close(got["state"], want["state"])


def test_radio_with_mesh_gathers_vad_flags(results):
    """Radio(mesh=...) with the options: the global audio and the VAD flags
    of every frame, gathered along time as the reference's out_specs do."""
    got, want = results[0][("radio", (2, 2))], results[1]["rx options"]
    for blk, (g, w) in enumerate(zip(got["out"], want["out"])):
        if blk > 0:
            _audio_close(g[0], w[0])
    for g, w in zip(got["vad"], want["vad"]):
        assert g.shape == w.shape == (C, T // 32 // 256)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_duplex_matches_unsharded(results, mesh):
    got, want = results[0][("duplex", mesh)], results[1]["duplex"]
    for blk, (g, w) in enumerate(zip(got["out"], want["out"])):
        if blk > 0:
            _audio_close(g[0], w[0])
        np.testing.assert_allclose(g[1], w[1], atol=5e-4)
    for g, w in zip(got["vad"], want["vad"]):
        np.testing.assert_array_equal(g, w)
    _rx_state_close(got["state"]["rx"], want["state"]["rx"])
    _tx_state_close(got["state"]["tx"], want["state"]["tx"])


def _same_specs(t_specs, j_specs):
    if isinstance(t_specs, P):
        assert tuple(t_specs) == tuple(j_specs), (t_specs, j_specs)
    elif isinstance(t_specs, dict):
        assert set(t_specs) == set(j_specs)
        for k in t_specs:
            _same_specs(t_specs[k], j_specs[k])
    else:
        assert isinstance(t_specs, tuple) and len(t_specs) == len(j_specs)
        for a, b in zip(t_specs, j_specs):
            _same_specs(a, b)


def test_sharded_state_specs(results):
    """The duplex's spec tree ({"rx": ..., "tx": ...}) names the axis of
    each leaf as the reference's ShardedDuplex does; its state tree has the
    reference's structure."""
    from radioframe.pipelines.duplex import DuplexChain as JDuplex
    from radioframe.shard.duplex import ShardedDuplex as JShardedDuplex

    j_rx = _rx_cfg(jcfg, fuse_frontend=True, fuse_frontend_depth=1, halo_transport="rdma",
                   **OPTIONS)
    jdpx = JDuplex(j_rx, _tx_cfg(jcfg))
    jmesh = jax.make_mesh((2, 2), ("channel", "time"), devices=jax.devices()[:4])
    got = results[0][("duplex", (2, 2))]
    _same_specs(got["specs"], JShardedDuplex(jdpx, jmesh).state_specs())
    want = jax.tree.map(np.asarray, jdpx.init_state(C))

    def same(t, j):
        if isinstance(j, dict):
            assert set(t) == set(j)
            for k in j:
                same(t[k], j[k])
        elif isinstance(j, tuple):
            assert isinstance(t, tuple) and len(t) == len(j)
            for a, b in zip(t, j):
                same(a, b)
        else:
            assert t.shape == j.shape and t.dtype == j.dtype

    same(got["state"], want)
