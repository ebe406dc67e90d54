"""Rank bodies for the port's sharded parity tests (test_torch_halo.py,
test_torch_sharded.py, test_torch_sharded_channelizer.py,
test_torch_sharded_tx.py, test_torch_mesh_checkpoint.py). Each runs in a
process spawned by
``radioframe_torch.shard.mesh.spawn`` on the CPU with gloo. This module
imports no JAX, so a rank never loads it; inputs arrive and results leave
as numpy arrays."""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.api.monitor import Monitor
from radioframe_torch.api.radio import NAME_BY_MODE, Radio
from radioframe_torch.convert import state_to_numpy
from radioframe_torch.core.config import AgcConfig, RxConfig
from radioframe_torch.kernels.halo_dma import HaloDma, causal_halo_dma, ring_halo_dma
from radioframe_torch.ops.nco import freq_word
from radioframe_torch.ops.biquad import BiquadCascade
from radioframe_torch.pipelines.channelizer import ChannelizerChain, ChannelizerConfig
from radioframe_torch.pipelines.duplex import DuplexChain
from radioframe_torch.pipelines.rx_chain import RxChain
from radioframe_torch.pipelines.tx_chain import TxChain
from radioframe_torch.shard import halo
from radioframe_torch.shard.channelizer import ShardedChannelizer
from radioframe_torch.shard.duplex import ShardedDuplex
from radioframe_torch.shard.mesh import gather_state, make_hybrid_mesh, make_mesh, shard_state
from radioframe_torch.shard.rx import ShardedRxChain
from radioframe_torch.shard.tx import ShardedTxChain


def _t(a):
    return torch.from_numpy(np.array(a))


def _local(a, axis):
    """This rank's time shard of a global (C, T) array."""
    n = a.shape[-1] // axis.size
    return _t(a[..., axis.index * n:(axis.index + 1) * n])


def halo_cases(rank, world, cases):
    """Run each (name, kind, args) case of the halo functions on a (1, world)
    mesh; returns this rank's {name: [outputs]} (global inputs in, local
    outputs out) and K7's launch count."""
    mesh = make_mesh(1, world, device="cpu")
    ax = mesh.axis("time")
    dma = HaloDma(ax)
    out = {}
    for name, kind, args in cases:
        if kind in ("causal_halo", "causal_halo_dma", "causal_halo_dma_pp"):
            x, carry, H = args
            xl = _local(x, ax)
            if kind == "causal_halo":
                xp, c = halo.causal_halo(xl, _t(carry), H, ax)
            else:
                xp, c = causal_halo_dma(xl, _t(carry), H, dma,
                                        ppermute_fallback=kind.endswith("_pp"))
            res = [xp, c]
        elif kind == "ring_halo_dma":
            x, H = args
            res = [ring_halo_dma(_local(x, ax), H, dma)]
        elif kind == "last_shard_value":
            res = [halo.last_shard_value(_local(args[0], ax)[:, -1], ax)]
        elif kind in ("affine_carry_chain", "max_carry_chain"):
            finals, A, carry = args  # finals (D, C): each shard's local final value
            f = _t(finals[ax.index])
            if kind == "affine_carry_chain":
                res = list(halo.affine_carry_chain(f, _t(A), _t(carry), ax))
            else:
                res = list(halo._carry_chain(f, _t(A), _t(carry), ax, torch.maximum))
        elif kind == "sharded_affine_scan":
            a, b, carry, table = args
            res = list(halo.sharded_affine_scan(a if np.ndim(a) == 0 else _t(a), _local(b, ax),
                                                _t(carry), ax, a_table=table))
        elif kind == "sharded_maxdecay_scan":
            a, v, carry, table, idx = args
            res = list(halo.sharded_maxdecay_scan(_t(a), _local(v, ax), _t(carry), ax,
                                                  a_table=table,
                                                  a_index=None if idx is None else _t(idx)))
        else:
            raise ValueError(kind)
        out[name] = [r.numpy() for r in res]
    out["__launches__"] = dma.launches
    return out


def chain_cases(rank, world, meshes, cases, blocks, freqs, modes):
    """Stream ``blocks`` (global (C, T) complex64) through ShardedRxChain on
    each (channel, time) mesh for each (name, RxConfig kwargs) case, or
    through Radio(mesh=...) where the name starts with "radio". Returns, on
    rank 0 only (the rest is the same after the gathers), {mesh: {name:
    {"audio": [(C, Ta) per block], "power_in": [(C,) per block], "state":
    the final global state, "specs": the spec tree}}} ("audio" and the last
    block's "power_in" for a Radio)."""
    out = {}
    for shape in meshes:
        mesh = make_mesh(*shape, device="cpu")
        out[tuple(shape)] = {name: _chain_case(RxConfig(**kw), name, mesh, blocks, freqs, modes)
                             for name, kw in cases[tuple(shape)]}
    return out if rank == 0 else None


def _chain_case(cfg, name, mesh, blocks, freqs, modes):
    if name.startswith("radio"):
        return _radio_case(cfg, mesh, blocks, freqs, modes)
    ca, ta = mesh.axis("channel"), mesh.axis("time")
    C = freqs.shape[0]
    cs = slice(ca.index * (C // ca.size), (ca.index + 1) * (C // ca.size))
    words = freq_word(freqs, cfg.fs_in)
    sharded = ShardedRxChain(RxChain(cfg), mesh)
    specs = sharded.state_specs()
    st = shard_state(sharded.init_state(C), specs, mesh)
    audio, power = [], []
    for b in blocks:
        iq = _local(b[cs], ta)
        st, a, aux = sharded.step(st, iq, _t(words[cs]), _t(modes[cs]))
        # power_in from the fused kernels' sums: unchanged from the full-rate
        # pass over the local block it replaced
        pw = ta.psum(torch.sum(torch.abs(iq) ** 2, dim=-1)) / (ta.size * iq.shape[-1])
        np.testing.assert_allclose(aux["power_in"].numpy(),
                                   pw.expand(aux["power_in"].shape).numpy(), rtol=1e-6)
        a = torch.cat(list(ta.all_gather(a)), dim=-1)
        audio.append(torch.cat(list(ca.all_gather(a)), dim=0).numpy())
        power.append(torch.cat(list(ca.all_gather(aux["power_in"])), dim=0).numpy())
    state = state_to_numpy(gather_state(st, specs, mesh))
    sharded.close()
    return {"audio": audio, "power_in": power, "state": state, "specs": specs}


def _radio_case(cfg, mesh, blocks, freqs, modes):
    radio = Radio(cfg, device="cpu", mesh=mesh)
    for ch, (f, m) in enumerate(zip(freqs, modes)):
        radio.tune(ch, float(f))
        radio.set_mode(ch, NAME_BY_MODE[int(m)])
    audio = [radio.process(b) for b in blocks]
    metrics = radio.metrics()
    radio.close()
    return {"audio": audio, "power_in": [metrics["power_in"]]}


def channelizer_config(kw: dict) -> ChannelizerConfig:
    """A ChannelizerConfig from plain values: "agc_modes" as a tuple of
    AgcConfig keyword dicts (pickled as such across the spawn)."""
    kw = dict(kw)
    if kw.get("agc_modes") is not None:
        kw["agc_modes"] = tuple(AgcConfig(**a) for a in kw["agc_modes"])
    return ChannelizerConfig(**kw)


def channelizer_cases(rank, world, cases, blocks, a2a_inputs):
    """The sharded channelizer's cases. ``cases``: (name, mesh shape, config
    kwargs, mode (M,), force_general or "monitor"), each streaming
    ``blocks`` (global (T,) complex64) through ShardedChannelizer, or
    through Monitor(mesh=...) for "monitor". ``a2a_inputs``: (split_dim,
    concat_dim, [x per rank]) cases of Axis.all_to_all on a (1, world) mesh.
    Returns {"a2a": [this rank's outputs], "init_equal": {name: whether
    this rank's initial state is ``ShardedChannelizer.init_state()`` (for
    "monitor", split by ``shard_state``, and equal to the Monitor's own),
    leaf for leaf}} on every rank and, on rank 0, {name: {"audio",
    "waterfall", "channel_power": one per block, "state": the final global
    state, "init_state": ``init_state()``, "one_mode", "specs",
    "demod_m"}}."""
    meshes = {}
    out = {"a2a": [], "init_equal": {}}
    for shape in sorted({tuple(c[1]) for c in cases} | {(1, world)}):
        meshes[shape] = make_mesh(*shape, device="cpu")
    ax = meshes[(1, world)].axis("time")
    for split, concat, xs in a2a_inputs:
        out["a2a"].append(ax.all_to_all(_t(xs[rank]), split, concat).numpy())
    for name, shape, kw, mode, opt in cases:
        res = _channelizer_case(channelizer_config(kw), meshes[tuple(shape)], blocks, mode, opt)
        out["init_equal"][name] = res.pop("init_equal")
        if rank == 0:
            out[name] = res
    return out


def _channelizer_case(cfg, mesh, blocks, mode, opt):
    ta = mesh.axis("time")
    res = {"audio": [], "waterfall": [], "channel_power": []}
    if opt == "monitor":
        mon = Monitor(cfg, device="cpu", mesh=mesh)
        init = mon.sharded.init_state()
        init_equal = _trees_equal(
            state_to_numpy(shard_state(init, mon.sharded.state_specs(), mesh)),
            state_to_numpy(mon.state))
        for c, m in enumerate(mode):
            mon.set_mode(c, NAME_BY_MODE[int(m)])
        for b in blocks:
            res["audio"].append(mon.process(b))
            res["waterfall"].append(mon.waterfall())
            res["channel_power"].append(mon.channel_power())
        sharded, state = mon.sharded, mon.global_state()
    else:
        sharded = ShardedChannelizer(ChannelizerChain(cfg), mesh, force_general=opt)
        specs = sharded.state_specs()
        init = sharded.init_state()
        init_equal = _trees_equal(state_to_numpy(init), state_to_numpy(sharded.chain.init_state()))
        st = shard_state(init, specs, mesh)
        for b in blocks:
            with torch.no_grad():
                st, a, aux = sharded.step(st, _local(b, ta), _t(mode))
                a, aux = sharded.gather(a, aux)
            res["audio"].append(a.numpy())
            res["waterfall"].append(aux["waterfall"].numpy())
            res["channel_power"].append(aux["channel_power"].numpy())
        state = gather_state(st, specs, mesh)
    res.update(state=state_to_numpy(state), init_state=state_to_numpy(init), init_equal=init_equal,
               one_mode=sharded.one_mode, specs=sharded.state_specs(),
               demod_m=None if sharded.demod_kernel is None else sharded.demod_kernel.M)
    return res


def _gather2(x, mesh):
    """A (C_local, T_local) shard -> the global (C, T) array, on every rank."""
    x = torch.cat(list(mesh.axis("time").all_gather(x)), dim=-1)
    return torch.cat(list(mesh.axis("channel").all_gather(x)), dim=0).numpy()


def _cslice(mesh, C: int) -> slice:
    ca = mesh.axis("channel")
    return slice(ca.index * (C // ca.size), (ca.index + 1) * (C // ca.size))


def tx_cases(rank, world, cases):
    """The transmit side's and the RX options' sharded cases: (name, mesh
    shape, kind, args), each streaming its global blocks through the
    sharded form. Kinds: "biquad" (sos, [x (C, T) f32]) through
    sharded_biquad_cascade; "tx" (TxConfig, [audio (C, Ta)], words, modes)
    through ShardedTxChain; "tx_drift" (the same) through ShardedTxChain
    run free, returning {"phases": the global FM phase after each block};
    "rx" (RxConfig, [iq (C, T)], words, modes)
    through ShardedRxChain; "duplex" (RxConfig, TxConfig, [iq], [audio],
    rx words, rx modes, tx words, tx modes) through ShardedDuplex; "radio"
    (RxConfig, [iq], freqs, modes) through Radio(mesh=...). Returns,
    on rank 0, {name: {"out": [per block, the step's global tensor outputs
    (iq; audio; audio, tx iq; or y)], "state": the final global state,
    "specs": the spec tree, "vad": the global VAD flags per block}}."""
    meshes = {shape: make_mesh(*shape, device="cpu") for shape in sorted({c[1] for c in cases})}
    out = {}
    for name, shape, kind, args in cases:
        res = _TX_KINDS[kind](meshes[shape], *args)
        if rank == 0:
            out[name] = res
    return out if rank == 0 else None


def _biquad_case(mesh, sos, blocks):
    ta, casc = mesh.axis("time"), BiquadCascade(sos)
    cs = _cslice(mesh, blocks[0].shape[0])
    st = tuple(s[cs] for s in casc.init_state(blocks[0].shape[0]))
    ys = []
    for x in blocks:
        y, st = halo.sharded_biquad_cascade(casc, st, _local(x[cs], ta), ta)
        ys.append([_gather2(y, mesh)])
    state = tuple(torch.cat(list(mesh.axis("channel").all_gather(s)), dim=0).numpy() for s in st)
    return {"out": ys, "state": state}


def _sharded_run(mesh, sharded, C: int, blocks, step):
    """Stream local blocks through ``step(state, *block) -> (state,
    outputs...)``; gathers each block's tensor outputs and VAD flags."""
    specs = sharded.state_specs()
    st = shard_state(sharded.init_state(C), specs, mesh)
    res = {"out": [], "vad": []}
    with torch.no_grad():
        for blk in blocks:
            st, *outs = step(st, *blk)
            res["out"].append([_gather2(o, mesh) for o in outs if isinstance(o, torch.Tensor)])
            aux = outs[-1] if isinstance(outs[-1], dict) else {}
            if "vad_active" in aux:
                res["vad"].append(_gather2(aux["vad_active"], mesh))
    res.update(state=state_to_numpy(gather_state(st, specs, mesh)), specs=specs)
    return res


def _tx_case(mesh, cfg, blocks, words, modes):
    ta, cs = mesh.axis("time"), _cslice(mesh, modes.shape[0])
    sharded = ShardedTxChain(TxChain(cfg), mesh)
    return _sharded_run(mesh, sharded, modes.shape[0], [(_local(a[cs], ta),) for a in blocks],
                        lambda st, a: sharded.step(st, a, _t(words[cs]), _t(modes[cs])))


def _tx_drift_case(mesh, cfg, blocks, words, modes):
    """ShardedTxChain run free over the blocks: the global FM phase carried
    out of each block (no other output is gathered)."""
    ca, ta, cs = mesh.axis("channel"), mesh.axis("time"), _cslice(mesh, modes.shape[0])
    sharded = ShardedTxChain(TxChain(cfg), mesh)
    st = shard_state(sharded.init_state(modes.shape[0]), sharded.state_specs(), mesh)
    phases = []
    with torch.no_grad():
        for a in blocks:
            st, _ = sharded.step(st, _local(a[cs], ta), _t(words[cs]), _t(modes[cs]))
            phases.append(torch.cat(list(ca.all_gather(st["fm_phase"])), dim=0).numpy())
    return {"phases": phases}


def _rx_case(mesh, cfg, blocks, words, modes):
    ta, cs = mesh.axis("time"), _cslice(mesh, modes.shape[0])
    sharded = ShardedRxChain(RxChain(cfg), mesh)
    res = _sharded_run(mesh, sharded, modes.shape[0], [(_local(b[cs], ta),) for b in blocks],
                       lambda st, x: sharded.step(st, x, _t(words[cs]), _t(modes[cs])))
    sharded.close()
    return res


def _duplex_case(mesh, rx_cfg, tx_cfg, iq, audio, rx_words, rx_modes, tx_words, tx_modes):
    ta, cs = mesh.axis("time"), _cslice(mesh, rx_modes.shape[0])
    sharded = ShardedDuplex(DuplexChain(rx_cfg, tx_cfg), mesh)
    ws = [_t(w[cs]) for w in (rx_words, rx_modes, tx_words, tx_modes)]
    res = _sharded_run(mesh, sharded, rx_modes.shape[0],
                       [(_local(x[cs], ta), _local(a[cs], ta)) for x, a in zip(iq, audio)],
                       lambda st, x, a: sharded.step(st, x, a, *ws))
    sharded.close()
    return res


def _radio_options_case(mesh, cfg, blocks, freqs, modes):
    """Radio(mesh=...) with the RX options: the global audio and VAD flags."""
    radio = Radio(cfg, device="cpu", mesh=mesh)
    for ch, (f, m) in enumerate(zip(freqs, modes)):
        radio.tune(ch, float(f))
        radio.set_mode(ch, NAME_BY_MODE[int(m)])
    res = {"out": [], "vad": []}
    for b in blocks:
        res["out"].append([radio.process(b)])
        res["vad"].append(radio.metrics()["vad_active"])
    radio.close()
    return res


_TX_KINDS = {"biquad": _biquad_case, "tx": _tx_case, "tx_drift": _tx_drift_case, "rx": _rx_case,
             "duplex": _duplex_case, "radio": _radio_options_case}


def checkpoint_cases(rank, world, cases, hybrid):
    """Save/load under a (1, world) mesh, and the hybrid mesh.

    ``cases``: (name, kind, config, blocks, controls, saved, unsharded), kind
    "radio" (RxConfig, (C, T) blocks, controls (freqs, modes)) or "monitor"
    (ChannelizerConfig kwargs, (T,) blocks, controls the modes). The object
    on the mesh runs blocks 0-1, saves as epoch 1 under ``saved`` and runs
    the rest ("cont"); a fresh one loads ``saved`` and runs the rest
    ("resumed"); a fresh one loads the unsharded object's checkpoint under
    ``unsharded`` and runs the rest ("cross"). ``hybrid``: (RxConfig, a (C,
    T) block, freqs, modes) stepped once through ShardedRxChain on
    make_hybrid_mesh(1, 2) with LOCAL_WORLD_SIZE=2 and on make_mesh(2, 2).
    Returns {name: {"cont", "resumed", "cross": [global audio per block],
    "epochs", "controls": the restored controls}} on rank 0 and
    {"hybrid": this rank's (channel, time) index, shape, refused, the two
    meshes' outputs equal} on every rank."""
    mesh = make_mesh(1, world, device="cpu")
    out = {}
    for name, kind, cfg, blocks, controls, saved, unsharded in cases:
        res = _checkpoint_case(mesh, kind, cfg, blocks, controls, saved, unsharded)
        if rank == 0:
            out[name] = res
    out["hybrid"] = _hybrid_case(world, *hybrid)
    return out


def _api_object(kind, cfg, controls, mesh):
    if kind == "radio":
        obj = Radio(cfg, device="cpu", mesh=mesh)
        for ch, (f, m) in enumerate(zip(*controls)):
            obj.tune(ch, float(f))
            obj.set_mode(ch, NAME_BY_MODE[int(m)])
    else:
        obj = Monitor(channelizer_config(cfg), device="cpu", mesh=mesh)
        for ch, m in enumerate(controls):
            obj.set_mode(ch, NAME_BY_MODE[int(m)])
    return obj


def _restored_controls(obj, kind):
    n = obj.config.channels if kind == "radio" else obj.num_channels
    modes = [obj.mode(c) for c in range(n)]
    return ([obj.frequency(c) for c in range(n)], modes) if kind == "radio" else modes


def _checkpoint_case(mesh, kind, cfg, blocks, controls, saved, unsharded):
    first = _api_object(kind, cfg, controls, mesh)
    for b in blocks[:2]:
        first.process(b)
    path = first.save(saved, epoch=1)
    res = {"path": path, "cont": [first.process(b) for b in blocks[2:]], "epochs": [],
           "controls": []}
    objs = [first]
    for key, directory in (("resumed", saved), ("cross", unsharded)):
        obj = _api_object(kind, cfg, np.zeros_like(controls), mesh)  # the load restores them
        res["epochs"].append(obj.load(directory))
        res["controls"].append(_restored_controls(obj, kind))
        res[key] = [obj.process(b) for b in blocks[2:]]
        objs.append(obj)
    if kind == "radio":
        for obj in objs:
            obj.close()
    return res


def _hybrid_case(world, cfg, block, freqs, modes):
    import os

    os.environ["LOCAL_WORLD_SIZE"] = "2"  # two "hosts" of two ranks each
    try:
        hyb = make_hybrid_mesh(1, world // 2, device="cpu")
        try:
            make_hybrid_mesh(1, world, device="cpu")  # 2 hosts x 1 x 4 ranks: too many
            refused = False
        except ValueError:
            refused = True
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    outs = []
    for mesh in (hyb, make_mesh(2, 2, device="cpu")):
        ca, ta = mesh.axis("channel"), mesh.axis("time")
        cs = _cslice(mesh, freqs.shape[0])
        sharded = ShardedRxChain(RxChain(cfg), mesh)
        st = shard_state(sharded.init_state(freqs.shape[0]), sharded.state_specs(), mesh)
        with torch.no_grad():
            st, a, _ = sharded.step(st, _local(block[cs], ta),
                                    _t(freq_word(freqs, cfg.fs_in)[cs]), _t(modes[cs]))
        state = gather_state(st, sharded.state_specs(), mesh)
        outs.append((_gather2(a, mesh), state_to_numpy(state)))
        sharded.close()
    (a_h, st_h), (a_m, st_m) = outs
    return {"index": (hyb.index("channel"), hyb.index("time")), "shape": dict(hyb.shape),
            "device": str(hyb.device), "refused": refused,
            "equal": bool(np.array_equal(a_h, a_m) and _trees_equal(st_h, st_m))}


def _trees_equal(a, b) -> bool:
    """Equal structure, and leaves of equal dtype and values."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(_trees_equal, a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def fail_on_rank1(rank, world):
    """For the launcher's own test: rank 1 raises, the others wait in a
    collective that never completes."""
    if rank == 1:
        raise ValueError("rank 1 was told to fail")
    torch.distributed.barrier()
    return rank
