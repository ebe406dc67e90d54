"""Config 3, the sharded DDC with halo exchange: the port's ShardedRxChain
and Radio(mesh=...) against the JAX package's RxChain and ShardedRxChain.

The port runs as four spawned gloo ranks on the CPU, one ``spawn`` per mesh
for all its cases, each with a timeout; the ranks' code
(``tests/torch_shard_ranks.py``) imports no JAX. The references run in this
process on the conftest's 8-device CPU mesh. Cases, as in
tests/test_sharded.py: C=8 (all six modes), ols_hop=512, two streamed blocks, meshes (1, 4),
(2, 2) and (4, 1); the dense front end, the fused depth-1 front end with
each halo transport (K2, and K7's plain route for "rdma"), and the fused
depth-2 front end (K1).

Tolerances are the reference's own: audio 2e-4 after the WARMUP=512
mode-filter transient (NFM rows modulo fs/deviation = 19.2, the size of an
atan2 branch flip), the decimator carries 1e-5, power_in rtol 1e-5; the
DDS accumulators exactly. The state tree and its layout are checked too."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radioframe.api.radio import Radio as JRadio
from radioframe.core.config import RxConfig
from radioframe.ops import nco
from radioframe.pipelines.rx_chain import RxChain
from radioframe.shard.mesh import place_state
from radioframe.shard.rx import ShardedRxChain
from radioframe_torch.shard.mesh import P, spawn

C, FS, BLOCKS, WARMUP = 8, 192_000.0, 2, 512
NFM_PERIOD = 19.2  # fs_audio / deviation: 48 kHz / 2.5 kHz
RANKS_TIMEOUT_S = 240.0
MESHES = [(1, 4), (2, 2), (4, 1)]
BASE = dict(channels=C, ols_hop=512)
CASES = {
    "dense": BASE,
    "fused1 ppermute": dict(BASE, fuse_frontend=True, fuse_frontend_depth=1),
    "fused1 rdma": dict(BASE, fuse_frontend=True, fuse_frontend_depth=1, halo_transport="rdma"),
    "fused2": dict(BASE, fuse_frontend=True, fuse_frontend_depth=2),
}
RADIO_MESH = (2, 2)
FREQS = np.linspace(-80e3, 80e3, C)
MODES = (np.arange(C) % 6).astype(np.int32)  # SSB, CW, AM, NFM, LSB, SAM, SSB, CW


def _blocks():
    rng = np.random.default_rng(3)
    T = 4 * RxChain(RxConfig(**BASE)).min_block  # T_local >= min_block on 4 shards
    return [(rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
            for _ in range(BLOCKS)]


BLOCKS_IQ = _blocks()


def _port_all():
    """Every mesh's cases in one spawn of four ranks."""
    import torch_shard_ranks  # tests/ is on the path; the ranks import it too

    cases = {m: list(CASES.items()) for m in MESHES}
    cases[RADIO_MESH].append(("radio fused1 rdma", CASES["fused1 rdma"]))
    return spawn(torch_shard_ranks.chain_cases, 4, MESHES, cases, BLOCKS_IQ, FREQS, MODES,
                 timeout_s=RANKS_TIMEOUT_S)[0]


def _run_jax(step, init):
    words = jnp.asarray(nco.freq_word(FREQS, FS))
    st, audio, power = init, [], []
    for b in BLOCKS_IQ:
        st, a, aux = step(st, jnp.asarray(b), words, jnp.asarray(MODES))
        audio.append(np.asarray(a))
        power.append(np.asarray(aux["power_in"]))
    return {"audio": audio, "power_in": power, "state": jax.tree.map(np.asarray, st)}


def _jmesh(shape):
    return jax.make_mesh(shape, ("channel", "time"), devices=jax.devices()[: shape[0] * shape[1]])


def _references():
    """The JAX RxChain per configuration (the transport does not change the
    unsharded chain), the JAX ShardedRxChain on RADIO_MESH, and the JAX
    Radio with that mesh."""
    unsharded, sharded = {}, {}
    jmesh = _jmesh(RADIO_MESH)
    for name, kw in CASES.items():
        chain = RxChain(RxConfig(**kw))
        key = name.replace(" rdma", " ppermute")
        if key not in unsharded:
            unsharded[key] = _run_jax(jax.jit(chain.step), chain.init_state(C))
        unsharded[name] = unsharded[key]
        sh = ShardedRxChain(chain, jmesh)
        # the state placed on its shardings: both blocks use one compiled step
        init = place_state(chain.init_state(C), sh.state_specs(), jmesh)
        sharded[name] = _run_jax(jax.jit(sh.step), init)
    radio = JRadio(RxConfig(**CASES["fused1 rdma"]), mesh=jmesh)
    for ch, (f, m) in enumerate(zip(FREQS, MODES)):
        radio.tune(ch, float(f))
        radio.set_mode(ch, ("ssb", "cw", "am", "nfm", "lsb", "sam")[m])
    audio = [radio.process(b) for b in BLOCKS_IQ]
    return unsharded, sharded, {"audio": audio, "power_in": [radio.metrics()["power_in"]]}


@pytest.fixture(scope="module")
def results():
    """(port, unsharded, sharded, radio): the port's results, computed in
    spawned ranks (which need no JAX) while this process builds the
    references."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_port_all)
        refs = _references()
        return (fut.result(), *refs)


def _audio_close(got, want):
    d = np.concatenate(got, axis=-1) - np.concatenate(want, axis=-1)
    nfm = MODES == 3
    d[nfm] -= NFM_PERIOD * np.round(d[nfm] / NFM_PERIOD)
    np.testing.assert_allclose(d[:, WARMUP:], 0.0, atol=2e-4)


def _same_structure(t_tree, j_tree):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree)
        for k in j_tree:
            _same_structure(t_tree[k], j_tree[k])
    elif isinstance(j_tree, tuple):
        assert isinstance(t_tree, tuple) and len(t_tree) == len(j_tree)
        for a, b in zip(t_tree, j_tree):
            _same_structure(a, b)
    else:
        assert t_tree.shape == j_tree.shape and t_tree.dtype == j_tree.dtype


def _same_specs(t_specs, j_specs):
    """The port's P tree names the same axis per dimension as the reference's
    PartitionSpec tree; () for a disabled feature in both."""
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


def _close(got, want):
    _audio_close(got["audio"], want["audio"])
    for p, q in zip(got["power_in"], want["power_in"]):
        np.testing.assert_allclose(p, q, rtol=1e-5)
    st_t, st_j = got["state"], want["state"]
    _same_structure(st_t, st_j)
    np.testing.assert_array_equal(st_t["nco"], st_j["nco"])
    np.testing.assert_array_equal(st_t["demod"]["cw_phase"], st_j["demod"]["cw_phase"])
    for a, b in zip(st_t["decim"], st_j["decim"]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(st_t["bpf"], st_j["bpf"], atol=2e-4)
    for k in ("am_dc", "sam_dc", "sam_carrier"):
        np.testing.assert_allclose(st_t["demod"][k], st_j["demod"][k], atol=2e-4, err_msg=k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_unsharded(results, mesh, case):
    """The port's sharded chain on every mesh == the JAX unsharded chain."""
    _close(results[0][mesh][case], results[1][case])


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_sharded(results, case):
    """The port's sharded chain == the JAX ShardedRxChain, mesh (2, 2)."""
    _close(results[0][RADIO_MESH][case], results[2][case])


@pytest.mark.parametrize("case", list(CASES))
def test_state_layout_matches_reference(results, case):
    chain = RxChain(RxConfig(**CASES[case]))
    j_specs = ShardedRxChain(chain, _jmesh(RADIO_MESH)).state_specs()
    got = results[0][RADIO_MESH][case]
    _same_specs(got["specs"], j_specs)
    _same_structure(got["state"], jax.tree.map(np.asarray, chain.init_state(C)))


def test_radio_with_mesh_matches_reference(results):
    """Radio(cfg, device="cpu", mesh=...) on every rank returns the global
    audio of the JAX Radio(cfg, mesh=...)."""
    got, want = results[0][RADIO_MESH]["radio fused1 rdma"], results[3]
    assert all(a.shape == (C, BLOCKS_IQ[0].shape[-1] // 4) for a in got["audio"])
    _audio_close(got["audio"], want["audio"])
    np.testing.assert_allclose(got["power_in"][0], want["power_in"][0], rtol=1e-5)
