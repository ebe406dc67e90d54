"""Config 5 on a mesh: the port's ShardedChannelizer and Monitor(mesh=...)
against the JAX package's ShardedChannelizer and the unsharded chains, and
``Axis.all_to_all`` against numpy.

The port runs as four spawned gloo ranks on the CPU, every case in one
``spawn`` with a timeout (rank bodies in ``tests/torch_shard_ranks.py``,
which imports no JAX); a D = 1 case runs on the (4, 1) mesh and a D = 2
case on (2, 2), the ranks along the channel axis repeating it. The
references run in this process, the JAX ones on the conftest's CPU mesh.
M = 64 channels at 15 kHz, K = 8, 4-frame waterfall lines, two blocks of
T = 4096 samples (F_local = 16 frames at D = 4).

Cases: the single-pass form at D = 1 ("defer"), 2 and 4 ("xla"), with
nonzero attack at D = 4; "emit_env" (AM off) at D = 4 with instant and
nonzero attack; ``force_general`` at D = 1 in both tiers; hang AGC at D = 1
("defer"); the two-kernel form at D = 4 with K4 on M/D channels, with the
dense SAM bank, with the EMA Spectrum waterfall, and with hang AGC (the
dense route); Monitor(mesh=...) at D = 4 in the single-pass and two-kernel
forms against the unsharded port Monitor, ``global_state`` included;
``init_state()`` against the chain's on every rank, the Monitor's, and the
JAX ShardedChannelizer's; and the configurations the reference refuses,
refused alike.

Tolerances: audio 2e-4 (NFM rows modulo fs_channel/deviation = 6.0, an
atan2 branch flip), the first block held after the PFB's K = 8 warm-up
frames (near-zero partial frames under the AGC's max gain magnify ulps);
waterfall 1e-2 dB; channel power rtol 1e-4; ``cw_phase`` bit-equal; ``pfb``
1e-6; the other state leaves 2e-4."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radioframe.api.monitor import Monitor as JMonitor
from radioframe.core.config import AgcConfig as JAgcConfig
from radioframe.pipelines import channelizer as jch
from radioframe.shard.channelizer import ShardedChannelizer as JSharded
from radioframe_torch.api.monitor import Monitor as TMonitor
from radioframe_torch.api.radio import NAME_BY_MODE
from radioframe_torch.convert import state_to_numpy
from radioframe_torch.pipelines import channelizer as tch
from radioframe_torch.shard.channelizer import ShardedChannelizer as TSharded
from radioframe_torch.shard.mesh import P, spawn

M, K, BLOCKS, T = 64, 8, 2, 4096
NFM_PERIOD = 6.0  # 15 kHz / 2.5 kHz
RANKS_TIMEOUT_S = 240.0
BASE = dict(fs_in=15_000.0 * M, num_channels=M, emit_spectrum=True, waterfall_from_pfb=True,
            waterfall_frame_avg=4, enabled_modes=(0, 1, 2, 3))
ONE = dict(BASE, fuse_pfb=True, fuse_demod=True, fuse_single_pass=True)
NO_AM = dict(ONE, enabled_modes=(0, 1, 3))
ATTACK = (dict(release_s=0.5, attack_s=0.002), dict(release_s=0.25, attack_s=0.001),
          dict(release_s=0.8, attack_s=0.005), dict(), dict(release_s=0.5, attack_s=0.002),
          dict(release_s=0.8, attack_s=0.005))
NO_AM_ATTACK = (dict(attack_s=0.002), dict(attack_s=0.001), dict(), dict(),
                dict(attack_s=0.002), dict())
HANG = (dict(release_s=0.5, attack_s=0.002, hang_s=0.01), dict(release_s=0.25, hang_s=0.005),
        dict(release_s=0.8, attack_s=0.005, hang_s=0.02), dict(),
        dict(release_s=0.5, attack_s=0.002, hang_s=0.01), dict(release_s=0.8, hang_s=0.02))
MODES4 = (np.arange(M) % 4).astype(np.int32)                    # SSB, CW, AM, NFM
MODES_NO_AM = np.array([0, 1, 3])[np.arange(M) % 3].astype(np.int32)
MODES6 = (np.arange(M) % 6).astype(np.int32)                    # all six, SAM included
# name -> (mesh, config, modes, force_general or "monitor", expected one_mode)
CASES = {
    "defer D=1": ((4, 1), ONE, MODES4, False, "defer"),
    "general xla D=1": ((4, 1), ONE, MODES4, True, "xla"),
    "general emit_env D=1": ((4, 1), NO_AM, MODES_NO_AM, True, "emit_env"),
    "hang defer D=1": ((4, 1), dict(ONE, agc_modes=HANG), MODES4, False, "defer"),
    "xla D=2": ((2, 2), ONE, MODES4, False, "xla"),
    "xla D=4": ((1, 4), ONE, MODES4, False, "xla"),
    "xla attack D=4": ((1, 4), dict(ONE, agc_modes=ATTACK), MODES4, False, "xla"),
    "emit_env D=4": ((1, 4), NO_AM, MODES_NO_AM, False, "emit_env"),
    "emit_env attack D=4": ((1, 4), dict(NO_AM, agc_modes=NO_AM_ATTACK), MODES_NO_AM, False,
                            "emit_env"),
    "two-kernel D=4": ((1, 4), dict(BASE, fuse_pfb=True, fuse_demod=True), MODES4, False, None),
    "dense SAM D=4": ((1, 4), dict(BASE, fuse_pfb=True, enabled_modes=None), MODES6, False,
                      None),
    "dense EMA D=4": ((1, 4), dict(BASE, waterfall_from_pfb=False, spectrum_nfft=256,
                                   spectrum_avg=0.7), MODES4, False, None),
    "two-kernel hang D=4": ((1, 4), dict(BASE, fuse_pfb=True, fuse_demod=True, agc_modes=HANG),
                            MODES4, False, None),
}
MONITORS = {
    "monitor single-pass D=4": ((1, 4), ONE, MODES4, "monitor", "xla"),
    "monitor two-kernel D=4": ((1, 4), dict(BASE, fuse_pfb=True, fuse_demod=True), MODES4,
                               "monitor", None),
}
# (split_dim, concat_dim, dtype, shape) of the all_to_all cases
A2A = [(0, 1, np.float32, (8, 3)), (2, 1, np.float32, (2, 5, 12)),
       (1, 0, np.complex64, (3, 4, 2)), (0, 0, np.int32, (4, 2))]


def _blocks():
    rng = np.random.default_rng(11)
    return [(rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)
            for _ in range(BLOCKS)]


BLOCKS_IQ = _blocks()


def _a2a_inputs():
    rng = np.random.default_rng(12)
    out = []
    for split, concat, dtype, shape in A2A:
        xs = [rng.standard_normal(shape) * 100 for _ in range(4)]
        if dtype == np.complex64:
            xs = [x + 1j * rng.standard_normal(shape) for x in xs]
        out.append((split, concat, [x.astype(dtype) for x in xs]))
    return out


A2A_INPUTS = _a2a_inputs()


def _port_all():
    """Every case in one spawn of four ranks."""
    import torch_shard_ranks  # tests/ is on the path; the ranks import it too

    cases = [(name, mesh, kw, modes, opt) for name, (mesh, kw, modes, opt, _) in
             {**CASES, **MONITORS}.items()]
    ranks = spawn(torch_shard_ranks.channelizer_cases, 4, cases, BLOCKS_IQ, A2A_INPUTS,
                  timeout_s=RANKS_TIMEOUT_S)
    port = ranks[0]
    for name, *_ in cases:
        port[name]["init_equal"] = [r["init_equal"][name] for r in ranks]
    return port, [r["a2a"] for r in ranks]


def _jconfig(kw):
    kw = dict(kw)
    if kw.get("agc_modes") is not None:
        kw["agc_modes"] = tuple(JAgcConfig(**a) for a in kw["agc_modes"])
    return jch.ChannelizerConfig(**kw)


def _tconfig(kw):
    import torch_shard_ranks

    return torch_shard_ranks.channelizer_config(kw)


def _run(step, st, modes):
    out = {"audio": [], "waterfall": [], "channel_power": []}
    for b in BLOCKS_IQ:
        st, a, aux = step(st, b, modes)
        out["audio"].append(np.asarray(a))
        out["waterfall"].append(np.asarray(aux["waterfall"]))
        out["channel_power"].append(np.asarray(aux["channel_power"]))
    return out, st


def _jax_sharded(kw, D, modes, force_general):
    chain = jch.ChannelizerChain(_jconfig(kw))
    sh = JSharded(chain, jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D]),
                  force_general=force_general)
    step = jax.jit(sh.step)
    out, st = _run(lambda s, b, m: step(s, jnp.asarray(b), jnp.asarray(m)),
                   jax.jit(chain.init_state)(), modes)
    out.update(state=jax.tree.map(np.asarray, st), one_mode=sh.one_mode,
               init_state=jax.tree.map(np.asarray, sh.init_state()),
               specs=sh.state_specs(),
               demod_m=None if sh.demod_kernel is None else sh.demod_kernel.M)
    return out


def _port_unsharded(kw, modes):
    chain = tch.ChannelizerChain(_tconfig(kw))
    with torch.no_grad():
        out, st = _run(lambda s, b, m: chain.step(s, torch.from_numpy(b), torch.from_numpy(m)),
                       chain.init_state(), modes)
    out["state"] = state_to_numpy(st)
    return out


def _jax_monitor(kw, modes):
    mon = JMonitor(_jconfig(kw))
    for c, m in enumerate(modes):
        mon.set_mode(c, NAME_BY_MODE[int(m)])
    out = {"audio": [], "waterfall": [], "channel_power": []}
    for b in BLOCKS_IQ:
        out["audio"].append(mon.process(b))
        out["waterfall"].append(mon.waterfall())
        out["channel_power"].append(mon.channel_power())
    return out


def _port_monitor(kw, modes):
    mon = TMonitor(_tconfig(kw), device="cpu")
    for c, m in enumerate(modes):
        mon.set_mode(c, NAME_BY_MODE[int(m)])
    out = {"audio": [], "waterfall": [], "channel_power": []}
    for b in BLOCKS_IQ:
        out["audio"].append(mon.process(b))
        out["waterfall"].append(mon.waterfall())
        out["channel_power"].append(mon.channel_power())
    out["state"] = state_to_numpy(mon.global_state())
    return out


def _references():
    """{name: (JAX sharded or JAX Monitor, port unsharded chain or Monitor)}."""
    refs = {}
    for name, (mesh, kw, modes, opt, _) in CASES.items():
        refs[name] = (_jax_sharded(kw, mesh[1], modes, opt), _port_unsharded(kw, modes))
    for name, (_, kw, modes, _, _) in MONITORS.items():
        refs[name] = (_jax_monitor(kw, modes), _port_monitor(kw, modes))
    return refs


@pytest.fixture(scope="module")
def results():
    """(port, a2a, references): the port's results from the spawned ranks
    (which need no JAX) while this process builds the references."""
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(_port_all)
        refs = _references()
        port, a2a = fut.result()
    return port, a2a, refs


def _outputs_close(got, want, modes):
    for blk in range(BLOCKS):
        a, b = np.asarray(got["audio"][blk]), np.asarray(want["audio"][blk])
        assert a.shape == b.shape == (M, T // M)
        d = (a - b)[:, K if blk == 0 else 0:]
        nfm = modes == 3
        d[nfm] -= NFM_PERIOD * np.round(d[nfm] / NFM_PERIOD)
        np.testing.assert_allclose(d, 0.0, atol=2e-4, err_msg=f"audio, block {blk}")
        np.testing.assert_allclose(got["waterfall"][blk], want["waterfall"][blk], atol=1e-2,
                                   err_msg=f"waterfall, block {blk}")
        np.testing.assert_allclose(got["channel_power"][blk], want["channel_power"][blk],
                                   rtol=1e-4, err_msg=f"channel power, block {blk}")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _flat(tree[k], f"{prefix}{k}.").items()}
    if isinstance(tree, tuple):
        assert tree == ()  # a disabled feature
        return {}
    return {prefix[:-1]: np.asarray(tree)}


def _states_close(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
        if k == "demod.cw_phase":
            np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6 if k == "pfb" else 2e-4,
                                       rtol=0 if k == "pfb" else 1e-5, err_msg=k)


def _specs_like_reference(t_specs, j_specs):
    """The port's spec tree names "time" where the reference names its one
    axis "dev"; the hang history's spec, which the reference's single-pass
    tree drops, is replicated (P(None, None)) in the port."""
    if isinstance(t_specs, P):
        if tuple(j_specs) == () and tuple(t_specs) == (None, None):
            return  # the hang history under "defer"
        assert tuple(t_specs) == tuple("time" if n == "dev" else n for n in j_specs)
    elif isinstance(t_specs, dict):
        assert set(t_specs) == set(j_specs)
        for k in t_specs:
            _specs_like_reference(t_specs[k], j_specs[k])
    else:
        assert t_specs == () and tuple(j_specs) == ()


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_sharded(results, case):
    """The port's sharded chain == the JAX ShardedChannelizer at the same D,
    in the same tier."""
    port, _, refs = results
    got, want = port[case], refs[case][0]
    assert got["one_mode"] == want["one_mode"] == CASES[case][4]
    assert got["demod_m"] == want["demod_m"]
    _outputs_close(got, want, CASES[case][2])
    _states_close(got["state"], want["state"])
    _specs_like_reference(got["specs"], want["specs"])


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_unsharded(results, case):
    """The port's sharded chain == the port's unsharded chain."""
    port, _, refs = results
    _outputs_close(port[case], refs[case][1], CASES[case][2])
    _states_close(port[case]["state"], refs[case][1]["state"])


@pytest.mark.parametrize("case", list(MONITORS))
def test_monitor_with_mesh_matches_unsharded(results, case):
    """Monitor(cfg, device="cpu", mesh=...) on every rank returns the global
    outputs of the unsharded port Monitor and of the JAX Monitor;
    ``global_state()`` is the unsharded Monitor's state."""
    port, _, refs = results
    got, (j, t) = port[case], refs[case]
    assert got["one_mode"] == MONITORS[case][4]
    _outputs_close(got, t, MONITORS[case][2])
    _outputs_close(got, j, MONITORS[case][2])
    _states_close(got["state"], t["state"])


@pytest.mark.parametrize("case", list(CASES) + list(MONITORS))
def test_init_state_is_chain_state(results, case):
    """On every rank, ``ShardedChannelizer.init_state()`` is the chain's
    ``init_state()`` leaf for leaf; under Monitor(mesh=...), split by
    ``shard_state``, it is the Monitor's own initial state."""
    assert results[0][case]["init_equal"] == [True] * 4


@pytest.mark.parametrize("case", list(CASES))
def test_init_state_matches_jax(results, case):
    """The port's ``ShardedChannelizer.init_state()`` has the tree, shapes,
    dtypes and values of the JAX ShardedChannelizer's."""
    port, _, refs = results
    _states_close(port[case]["init_state"], refs[case][0]["init_state"])


@pytest.mark.parametrize("i", range(len(A2A)), ids=[f"{a[2].__name__}{a[3]}" for a in A2A])
def test_all_to_all_matches_numpy(results, i):
    """Axis.all_to_all on four ranks: rank r gets part r of every rank's
    split dimension, joined along the concat dimension in rank order."""
    split, concat, xs = A2A_INPUTS[i]
    for r, outs in enumerate(results[1]):
        want = np.concatenate([np.split(x, 4, axis=split)[r] for x in xs], axis=concat)
        np.testing.assert_array_equal(outs[i], want)
        assert outs[i].dtype == want.dtype


class _Axis:
    name, index = "time", 0

    def __init__(self, size):
        self.size = size


class _Mesh:
    """Stands in for a mesh in the constructor's checks, which run no
    collective."""

    def __init__(self, D):
        self._ax = _Axis(D)

    def axis(self, name):
        return self._ax


REFUSED = {  # name -> (config, D, exception, match)
    "hang single-pass D=4": (dict(ONE, agc_modes=HANG), 4, ValueError, "hang"),
    "channels over D=3": (dict(BASE, fuse_pfb=True, fuse_demod=True), 3, AssertionError, None),
    "fast release per shard": (dict(BASE, fs_in=15_000.0 * 4096, num_channels=4096,
                                    fuse_pfb=True, fuse_demod=True,
                                    agc_modes=(dict(release_s=1.48e-3),) * 6),
                               8, ValueError, "per-shard"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refuses_what_the_reference_refuses(case):
    """Hang AGC in the single-pass form at D > 1, channels that do not
    split D ways, and a release too fast for the per-shard K4's frame tiles
    (which passes the unsharded guard) raise the reference's exceptions."""
    kw, D, exc, match = REFUSED[case]
    with pytest.raises(exc, match=match):
        JSharded(jch.ChannelizerChain(_jconfig(kw)),
                 jax.make_mesh((D,), ("dev",), devices=jax.devices()[:D]))
    chain = tch.ChannelizerChain(_tconfig(kw))
    with pytest.raises(exc, match=match):
        TSharded(chain, _Mesh(D))
