"""The compiled block step (core/compiled.py) at the port's API sites:
``Radio``, ``Monitor``, ``Transceiver`` and ``BlockStream`` (both
``donate`` values), on the CPU, where ``CompiledStep`` keeps its static
state and input buffers and calls the step directly (the CUDA graph's
capture and replay run in chip_smoke.py's phase graphs).

Each site runs 4 blocks with controls changed between them (a retune, a
mode change, a PTT toggle, block 2's state saved and loaded back) and is
held bit-equal to a loop of its chain's eager ``step`` with the same
controls. One Radio case is held against the JAX ``Radio`` (audio 2e-4
after block 0, the NFM channel modulo fs/deviation = 19.2). A block of
another length and an int16 block are signatures of their own; assigning
``state`` is seen by the next block; a change of the AGC's static scan
form or of the TX chain's float constants sets the signatures up again.

Inputs on the step's device (every tensor, on the CPU) are read in place:
a ring of buffers visited out of order is bound once a buffer and is
bit-equal to the copying path; new contents of a bound buffer are read; a
buffer beyond ``BIND_CAP`` and an input that is the step's own memory (a
previous output, a state leaf) are copied; ``compiled.bind`` carries the
bytes read in place and the bindings.
"""

import numpy as np
import pytest
import torch

from radioframe.api.radio import Radio as JRadio
from radioframe.core import config as jcfg
from radioframe_torch.api.monitor import Monitor
from radioframe_torch.api.radio import Radio
from radioframe_torch.api.transceiver import Transceiver
from radioframe_torch.core import compiled, presets
from radioframe_torch.core import config as tcfg
from radioframe_torch.core.compiled import CompiledStep
from radioframe_torch.core.stream import BlockStream
from radioframe_torch.diag import timing
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.rx_chain import RxChain

torch.set_num_threads(2)

C = 4
FS = 1_536_000.0
NAMES = ("ssb", "cw", "am", "nfm")
FREQS = (1e5, -2.5e5, 4e4, 6.5e5)
NFM_PERIOD = 19.2


def _rx_cfg(mod, **kw):
    """The flagship stage plan at C=4 (K1's plain version on the CPU)."""
    return mod.RxConfig(fs_in=FS, channels=C,
                        stages=(mod.CicStage(R=8, N=4),
                                mod.FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                        ols_hop=512, fuse_frontend=True, fuse_frontend_depth=2,
                        enabled_modes=(0, 1, 2, 3), **kw)


def _iq(rng, T, rows=C):
    return (rng.standard_normal((rows, T)) + 1j * rng.standard_normal((rows, T))).astype(
        np.complex64)


def _eq_tree(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _eq_tree(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq_tree(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def _radio(mod_radio, cfg, **kw):
    r = mod_radio(cfg, **kw)
    for ch in range(C):
        r.tune(ch, FREQS[ch])
        r.set_mode(ch, NAMES[ch])
    return r


def _radio_controls(r, blk, tmp_path):
    """The controls between blocks: a retune before block 1, a mode change
    before block 2 (and block 2's state saved), the state loaded back
    before block 3. Returns the saved epoch's directory."""
    if blk == 1:
        r.tune(0, 2.0e5)
    elif blk == 2:
        r.set_mode(1, "am")
        r.save(str(tmp_path / "ck"), epoch=2)
    elif blk == 3:
        assert r.load(str(tmp_path / "ck")) == 2


def test_radio_bit_equal_to_eager_across_controls(tmp_path):
    rng = np.random.default_rng(1)
    r = _radio(Radio, _rx_cfg(tcfg), device="cpu")
    blocks = [_iq(rng, 16384) for _ in range(4)]
    st, saved, ref = r.chain.init_state(C), None, RxChain(_rx_cfg(tcfg))
    for blk, x in enumerate(blocks):
        _radio_controls(r, blk, tmp_path)
        if blk == 2:
            saved = st
        elif blk == 3:
            st = saved
        words = torch.from_numpy(nco.freq_word(r._freqs, FS))
        with torch.no_grad():
            st, a_ref, aux_ref = ref.step(st, torch.from_numpy(x), words,
                                          torch.from_numpy(r._modes.copy()))
        a = r.process(x)
        np.testing.assert_array_equal(a, a_ref.numpy())
        _eq_tree(r.last_aux, aux_ref)
    _eq_tree(r.state, st)
    assert (r._compiled.signatures, r._compiled.blocks, r._compiled.captures) == (1, 4, 0)


def test_radio_matches_jax_across_controls(tmp_path):
    rng = np.random.default_rng(2)
    rt = _radio(Radio, _rx_cfg(tcfg), device="cpu")
    rj = _radio(JRadio, _rx_cfg(jcfg))
    T = 2 * 16384
    for blk in range(4):
        for r in (rt, rj):
            _radio_controls(r, blk, tmp_path / type(r).__module__)
        x = _iq(rng, T)
        a_t, a_j = rt.process(x), np.asarray(rj.process(x))
        assert a_t.shape == (C, T // 32)
        if blk > 0:  # block 0 carries the cold-start AGC transient
            d = a_t - a_j
            nfm = rt._modes == 3
            d[nfm] -= NFM_PERIOD * np.round(d[nfm] / NFM_PERIOD)
            assert float(np.abs(d).max()) <= 2e-4, blk


def test_radio_last_aux_survives_the_next_block():
    rng = np.random.default_rng(3)
    r = _radio(Radio, _rx_cfg(tcfg), device="cpu")
    r.process(_iq(rng, 16384))
    held = r.last_aux
    keep = {k: v.clone() for k, v in held.items()}
    r.process(_iq(rng, 16384))
    _eq_tree(held, keep)


def test_assigning_state_is_seen_by_the_next_block():
    rng = np.random.default_rng(4)
    blocks = [_iq(rng, 16384) for _ in range(3)]
    r = _radio(Radio, _rx_cfg(tcfg), device="cpu")
    other = _radio(Radio, _rx_cfg(tcfg), device="cpu")
    other.process(blocks[0])
    other.process(blocks[1])
    r.process(blocks[2])
    r.state = other.state  # the state after two other blocks
    np.testing.assert_array_equal(r.process(blocks[2]), other.process(blocks[2]))
    _eq_tree(r.state, other.state)
    held = r.state  # a copy: the next block leaves it as it is
    keep = compiled.clone_tree(held)
    r.process(blocks[0])
    _eq_tree(held, keep)


def test_agc_form_flip_sets_the_signature_up_again():
    """A release-table change within the static scan forms reaches the step
    through the device tables; one that flips a form (the attack) sets the
    signature up again. Both stay bit-equal to the eager step."""
    rng = np.random.default_rng(5)
    r = _radio(Radio, _rx_cfg(tcfg), device="cpu")
    ref = RxChain(_rx_cfg(tcfg))
    words = torch.from_numpy(nco.freq_word(r._freqs, FS))
    modes = torch.from_numpy(r._modes.copy())
    st = ref.init_state(C)
    bank = r.chain.agc_bank
    on = bank._alpha_table.any()  # flip the attack: off where it is on, else on
    changes = [None, dict(release=bank._release_table * np.float32(0.9999)),
               dict(alpha=np.full_like(bank._alpha_table, 0.0 if on else 0.9))]
    for blk, change in enumerate(changes):
        before = r._compiled.signatures
        forms = bank.forms(16384 // 32)
        if change is not None:
            bank.set_tables(**change)
            ref.agc_bank.set_tables(**change)
        flipped = bank.forms(16384 // 32) != forms
        assert flipped == (blk == 2)
        x = _iq(rng, 16384)
        with torch.no_grad():
            st, a_ref, _ = ref.step(st, torch.from_numpy(x), words, modes)
        np.testing.assert_array_equal(r.process(x), a_ref.numpy())
        assert r._compiled.signatures == before + (blk == 0 or flipped)


def _monitor_blocks(m, rng, n=4):
    T = 16 * m.chain.min_block
    return [(rng.standard_normal(T) + 1j * rng.standard_normal(T)).astype(np.complex64)
            for _ in range(n)]


def test_monitor_bit_equal_to_eager_across_controls(tmp_path):
    cfg = presets.channelizer_61m44(32, fs_in=32 * 15_000.0)  # K5's plain route
    m = Monitor(cfg, device="cpu")
    m.set_mode_all("am")
    blocks = _monitor_blocks(m, np.random.default_rng(6))
    st, saved = m.chain.init_state(), None
    for blk, x in enumerate(blocks):
        if blk == 1:
            m.set_mode(3, "nfm")
        elif blk == 2:
            m.save(str(tmp_path / "ck"), epoch=2)
            saved = st
        elif blk == 3:
            assert m.load(str(tmp_path / "ck")) == 2
            st = saved
        with torch.no_grad():
            st, a_ref, aux_ref = m.chain.step(st, torch.from_numpy(x),
                                              torch.from_numpy(m._modes.copy()))
        np.testing.assert_array_equal(m.process(x), a_ref.numpy())
        np.testing.assert_array_equal(m.waterfall(), aux_ref["waterfall"].numpy())
        np.testing.assert_array_equal(m.channel_power(), aux_ref["channel_power"].numpy())
    _eq_tree(m.state, st)
    assert (m._compiled.signatures, m._compiled.blocks) == (1, 4)


class _Site:
    """An API object on the CPU fed one block again and again: ``change(blk)``
    sets new controls, ``keep(path)``/``put_back(path)`` save the state and
    load it back, ``run()`` processes the block and ``eager(st)`` steps the
    chain eagerly with the object's controls; both give (state,) output:
    the RX audio, or the TX IQ while the Transceiver transmits."""

    def __init__(self, kind, rng):
        self.kind = kind
        if kind == "Radio":
            self.obj = _radio(Radio, _rx_cfg(tcfg), device="cpu")
            self.inputs = (_iq(rng, 16384),)
            self.ref = RxChain(_rx_cfg(tcfg))
            self.st = self.ref.init_state(C)
        elif kind == "Monitor":
            self.obj = Monitor(presets.channelizer_61m44(32, fs_in=32 * 15_000.0), device="cpu")
            self.inputs = tuple(_monitor_blocks(self.obj, rng, n=1))
            self.ref = self.obj.chain
            self.st = self.ref.init_state()
        else:
            self.obj = Transceiver(tcfg.RxConfig(channels=2), tcfg.TxConfig(channels=2),
                                   device="cpu")
            T = 4 * self.obj.chain.rx.min_block
            mic = rng.standard_normal((2, T // self.obj.rx_cfg.decim)).astype(np.float32)
            self.inputs = (_iq(rng, T, rows=2), 0.3 * mic)
            self.ref = self.obj.chain
            self.st = self.ref.init_state(2)

    def change(self, blk):
        o = self.obj
        if self.kind == "Radio":
            o.tune(blk % C, FREQS[blk % C] + 1_000.0 * blk)
            o.set_mode((blk + 1) % C, NAMES[blk % 4])
        elif self.kind == "Monitor":
            o.set_mode(blk, NAMES[(blk + 1) % 4])
        else:  # the VFOs, RIT/XIT, split, the receive VFO, a mode and PTT
            c = blk % 2
            o.tune(c, 7_000.0 + 500.0 * blk)
            o.vfo_b(1 - c, -5_000.0 - 250.0 * blk)
            o.rit(c, 10.0 * blk)
            o.xit(1 - c, -20.0 * blk)
            o.split(c, blk % 3 == 0)
            o.select_rx_vfo(1 - c, blk % 2)
            o.set_mode(c, ("ssb", "am", "nfm", "sam", "cw")[blk % 5])
            o.ptt(blk % 4 == 1)

    def keep(self, path):
        if self.kind == "Transceiver":
            self.saved_obj = self.obj.state
        else:
            self.obj.save(str(path), epoch=3)
        self.saved = self.st

    def put_back(self, path):
        if self.kind == "Transceiver":
            self.obj.state = self.saved_obj
        else:
            assert self.obj.load(str(path)) == 3
        self.st = self.saved

    def controls(self) -> list:
        o = self.obj
        if self.kind == "Radio":
            host = (nco.freq_word(o._freqs, FS), o._modes.copy())
        elif self.kind == "Monitor":
            host = (o._modes.copy(),)
        else:
            host = o.step_inputs()
        return [torch.from_numpy(v) for v in host]

    def eager(self):
        with torch.no_grad():
            self.st, *outs, _ = self.ref.step(self.st, *map(torch.from_numpy, self.inputs),
                                              *self.controls())
        return outs[-1 if self.obj.__dict__.get("_ptt") else 0].numpy()

    def run(self):
        out = self.obj.process(*self.inputs)
        if self.kind != "Transceiver":
            return out
        rx, tx = out
        assert not (rx if self.obj.transmitting else tx).any()
        return tx if self.obj.transmitting else rx


SITES = ["Radio", "Monitor", "Transceiver"]


@pytest.mark.parametrize("kind", SITES)
def test_control_changes_keep_one_binding(kind, tmp_path):
    """More than BIND_CAP control changes (retunes and mode changes; on the
    Transceiver its VFOs, RIT/XIT, split and PTT too), and the state saved
    and put back (save/load; the Transceiver's ``state``), each before a
    block read from one input buffer: the controls are rewritten in their
    device tensors, so the object keeps one binding and copies nothing, and
    every block is the eager step's with the new controls."""
    site = _Site(kind, np.random.default_rng(12))
    for blk in range(compiled.BIND_CAP + 4):
        site.change(blk)
        if blk == 3:
            site.keep(tmp_path / "ck")
        elif blk == 6:
            site.put_back(tmp_path / "ck")
        np.testing.assert_array_equal(site.run(), site.eager())
    cs = site.obj._compiled
    assert (cs.signatures, cs.binds, cs.copies, cs.blocks) == (1, 1, 0, compiled.BIND_CAP + 4)
    _eq_tree(site.obj.state, site.st)


class _Spy:
    """A ``CompiledStep`` seen through: the inputs of every call."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, *inputs):
        self.calls.append(inputs)
        return self.inner(*inputs)


@pytest.mark.parametrize("kind", SITES)
def test_controls_are_one_device_tensor_each(kind):
    """Every block hands the step the same control tensors, none of which
    shares memory with the object's numpy arrays; a write straight into a
    host array (as CAT's tests reset a Transceiver) reaches the next block,
    bit-equal to the eager step."""
    site = _Site(kind, np.random.default_rng(14))
    spy = site.obj._compiled = _Spy(site.obj._compiled)
    n_in = len(site.inputs)
    for blk in range(4):
        if blk == 2:
            site.obj._modes[:] = 2  # AM everywhere, no setter
        elif blk == 3 and kind != "Monitor":
            (site.obj._freqs if kind == "Radio" else site.obj._vfo_a)[:] = 12_345.0
        np.testing.assert_array_equal(site.run(), site.eager())
    controls = [call[n_in:] for call in spy.calls]
    assert len(controls) == 4 and len(controls[0]) == {"Radio": 2, "Monitor": 1}.get(kind, 4)
    assert all(a is b for later in controls[1:] for a, b in zip(controls[0], later))
    arrays = [v for v in vars(site.obj).values() if isinstance(v, np.ndarray)]
    assert arrays and not any(np.shares_memory(t.numpy(), a)
                              for t in controls[0] for a in arrays)


def test_transceiver_bit_equal_to_eager_across_controls():
    trx = Transceiver(tcfg.RxConfig(channels=2), tcfg.TxConfig(channels=2), device="cpu")
    for ch in range(2):
        trx.tune(ch, 7_000.0 + 3_000.0 * ch)
        trx.set_mode(ch, ("ssb", "am")[ch])
    rng = np.random.default_rng(7)
    T = 4 * trx.chain.rx.min_block
    Ta = T // trx.rx_cfg.decim
    st, saved, keep = trx.chain.init_state(2), None, None
    for blk in range(4):
        if blk == 1:
            trx.tune(0, 9_000.0)
            trx.ptt(True)
        elif blk == 2:
            trx.set_mode(1, "nfm")
            trx.ptt(False)
            saved, keep = trx.state, st
        elif blk == 3:
            trx.state = saved
            st = keep
        x = _iq(rng, T, rows=2)
        mic = rng.standard_normal((2, Ta)).astype(np.float32) * 0.3
        ctl = [torch.from_numpy(v) for v in trx.step_inputs()]
        with torch.no_grad():
            st, a_ref, iq_ref, _ = trx.chain.step(st, torch.from_numpy(x),
                                                  torch.from_numpy(mic), *ctl)
        rx_a, tx_iq = trx.process(x, mic)
        if trx.transmitting:
            assert not rx_a.any()
            np.testing.assert_array_equal(tx_iq, iq_ref.numpy())
        else:
            assert not tx_iq.any()
            np.testing.assert_array_equal(rx_a, a_ref.numpy())
    _eq_tree(trx.state, st)
    # a new TX float is read by value: it sets the signature up again
    n = trx._compiled.signatures
    trx.chain.tx.fm_k = trx.chain.tx.fm_k * 0.5
    x = _iq(rng, T, rows=2)
    mic = rng.standard_normal((2, Ta)).astype(np.float32)
    trx.ptt(True)
    ctl = [torch.from_numpy(v) for v in trx.step_inputs()]
    with torch.no_grad():
        _, _, iq_ref, _ = trx.chain.step(st, torch.from_numpy(x), torch.from_numpy(mic), *ctl)
    np.testing.assert_array_equal(trx.process(x, mic)[1], iq_ref.numpy())
    assert trx._compiled.signatures == n + 1


@pytest.mark.parametrize("donate", [True, False])
def test_block_stream_donation(donate):
    """Two runs (a retune between them), then block 2's state put back:
    bit-equal to the eager loop. Donated state tensors are consumed (they
    hold the stream's state); undonated ones stay as they were."""
    chain = RxChain(_rx_cfg(tcfg))
    rng = np.random.default_rng(8)
    blocks = [_iq(rng, 16384) for _ in range(4)]
    modes = torch.from_numpy(np.arange(C, dtype=np.int32))
    words = [torch.from_numpy(nco.freq_word(np.array(FREQS) + df, FS)) for df in (0.0, 500.0)]
    init = chain.init_state(C)
    init_copy = compiled.clone_tree(init)
    bs = BlockStream(chain.step, init, device="cpu", donate=donate)
    outs, _ = bs.run(iter(blocks[:2]), words[0], modes)
    saved = bs.state if not donate else compiled.clone_tree(bs.state)
    outs += bs.run(iter(blocks[2:3]), words[1], modes)[0]
    bs.state = saved
    outs += bs.run(iter(blocks[3:]), words[1], modes)[0]
    st, ref = chain.init_state(C), []
    with torch.no_grad():
        for blk, (x, w) in enumerate(zip(blocks, (words[0], words[0], words[1], words[1]))):
            if blk == 2:
                kept = st
            if blk == 3:
                st = kept
            st, a, _ = chain.step(st, torch.from_numpy(x), w, modes)
            ref.append(a)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    _eq_tree(bs.state, st)
    if donate:  # consumed: the caller's tensors are the stream's buffers
        assert bs.state["nco"] is init["nco"]
        _eq_tree(init, st)
    else:
        _eq_tree(init, init_copy)
        assert bs.state["nco"] is not bs.state["nco"]  # each read is a copy


def test_lengths_and_int16_blocks_are_signatures_of_their_own():
    """One CompiledStep fed complex blocks of two lengths and int16 count
    planes (the int16 route): three signatures, each block bit-equal to the
    eager step."""
    chain = RxChain(_rx_cfg(tcfg))
    chain16 = RxChain(_rx_cfg(tcfg, int16_ingest=True))  # the same state layout

    def step(state, block, words, modes):
        if isinstance(block, tuple):
            return chain16.step_i16(state, *block, words, modes)
        return chain.step(state, block, words, modes)

    rng = np.random.default_rng(9)
    words = torch.from_numpy(nco.freq_word(np.array(FREQS), FS))
    modes = torch.from_numpy(np.arange(C, dtype=np.int32))

    def counts(T):
        return tuple(torch.from_numpy(np.clip(np.round(rng.standard_normal((C, T)) * 8000.0),
                                              -32768, 32767).astype(np.int16)) for _ in range(2))

    blocks = [torch.from_numpy(_iq(rng, 16384)), torch.from_numpy(_iq(rng, 32768)), counts(16384),
              torch.from_numpy(_iq(rng, 16384)), counts(16384), torch.from_numpy(_iq(rng, 32768))]
    cs = CompiledStep(step, chain.init_state(C), device="cpu")
    st = chain.init_state(C)
    for blk in blocks:
        audio, aux = cs(blk, words, modes)
        with torch.no_grad():
            st, a_ref, aux_ref = step(st, blk, words, modes)
        assert torch.equal(audio, a_ref)
        _eq_tree(aux, aux_ref)
    _eq_tree(cs.state, st)
    assert (cs.signatures, cs.blocks) == (3, len(blocks))


def test_state_layout_and_values_leaves():
    """A step whose state is a plain value (the CPU only), an output that
    is the state's own buffer (cloned before the copy-back), a new state
    leaf that is another leaf's buffer, and a state of another layout."""
    cs = CompiledStep(lambda s, k: (s + k, s), 0, device="cpu")
    assert [cs(2)[0] for _ in range(3)] == [0, 2, 4] and cs.state == 6

    def swap(s):
        return {"a": s["b"], "b": s["a"]}, s["a"]

    s = {"a": torch.zeros(3), "b": torch.ones(3)}
    cs = CompiledStep(swap, s, device="cpu")
    (out,) = cs()
    assert torch.equal(out, torch.zeros(3)) and torch.equal(cs.state["a"], torch.ones(3))
    assert torch.equal(cs.state["b"], torch.zeros(3)) and out is not s["a"]
    cs.state = {"a": torch.zeros(5), "b": torch.ones(5)}  # another layout: new buffers
    assert torch.equal(cs()[0], torch.zeros(5)) and cs.state["a"].shape == (5,)
    with pytest.raises(ValueError, match="from the step"):
        CompiledStep(lambda s: ({"a": s["a"].double(), "b": s["b"]}, None), s,
                     device="cpu")()


class _Counted:
    def __init__(self):
        self.launches = 0
        self.variant_launches = {"x": 0, "y": 0}


def test_replayed_launch_counts():
    """What a capture recorded is what a replay adds (and the capture's own
    launches are recorded, not counted)."""
    w = _Counted()
    with compiled._build.recording() as delta:
        compiled._build.launched(w, "y")
        compiled._build.launched(w, "y")
    assert delta == [(w, 2, {"y": 2})]
    assert (w.launches, w.variant_launches) == (0, {"x": 0, "y": 0})
    for _ in range(3):
        compiled._build.advance(delta)
    assert (w.launches, w.variant_launches) == (6, {"x": 0, "y": 6})
    compiled._build.launched(w)
    assert (w.launches, w.variant_launches) == (7, {"x": 0, "y": 6})


def test_refusal_names_the_first_failing_line():
    def step():
        raise RuntimeError("operation not permitted when stream is capturing")

    try:
        try:
            step()
        finally:
            raise RuntimeError("capture invalidated")  # the capture's end, as torch raises it
    except RuntimeError as e:
        msg = compiled._refusal(e)
    assert "in step: raise RuntimeError(\"operation not permitted" in msg
    assert "test_torch_compiled_step.py" in msg and "capture invalidated" not in msg


def _ring_run(order, ring, words, modes):
    bs = BlockStream(RxChain(_rx_cfg(tcfg)).step, RxChain(_rx_cfg(tcfg)).init_state(C),
                     device="cpu")
    outs, auxs = bs.run((ring[i] for i in order), words, modes)
    return bs, outs, auxs


def test_block_stream_binds_a_ring_visited_out_of_order(monkeypatch):
    """A ring of 4 device buffers, visited 0, 2, 1, 3, 2, 0, 3, 1: one
    binding a buffer, nothing copied, bit-equal to the copying path (no
    binding allowed) on the same blocks."""
    rng = np.random.default_rng(10)
    ring = [torch.from_numpy(_iq(rng, 16384)) for _ in range(4)]
    words = torch.from_numpy(nco.freq_word(np.array(FREQS), FS))
    modes = torch.from_numpy(np.arange(C, dtype=np.int32))
    order = [0, 2, 1, 3, 2, 0, 3, 1]
    bs, outs, auxs = _ring_run(order, ring, words, modes)
    assert (bs.compiled.signatures, bs.compiled.binds, bs.compiled.copies) == (1, 4, 0)
    monkeypatch.setattr(compiled, "BIND_CAP", 0)
    ref, outs_ref, auxs_ref = _ring_run(order, ring, words, modes)
    assert (ref.compiled.binds, ref.compiled.copies) == (0, 3 * len(order))
    for a, b in zip(outs, outs_ref):
        assert torch.equal(a, b)
    _eq_tree(auxs, auxs_ref)
    _eq_tree(bs.state, ref.state)


def _acc_step(state, x):
    return {"acc": state["acc"] * 0.5 + x}, x * 2.0 + state["acc"]


def _acc_eager(acc, x):
    return acc * 0.5 + x, x * 2.0 + acc


def test_new_contents_of_a_bound_buffer_are_read():
    buf = torch.arange(8, dtype=torch.float32)
    cs = CompiledStep(_acc_step, {"acc": torch.zeros(8)}, device="cpu")
    acc = torch.zeros(8)
    for fill in (None, 3.0, -1.5):
        if fill is not None:
            buf.fill_(fill)
        (out,) = cs(buf)
        acc, want = _acc_eager(acc, buf)
        assert torch.equal(out, want) and out.data_ptr() != buf.data_ptr()
    assert (cs.binds, cs.copies, cs.blocks) == (1, 0, 3)
    assert torch.equal(cs.state["acc"], acc)


def test_buffers_beyond_the_cap_are_copied():
    """The ninth distinct buffer sets up the copying path, the tenth sets
    up nothing; both are copied, and every block is the eager step's."""
    bufs = [torch.full((8,), float(i)) for i in range(compiled.BIND_CAP + 2)]
    cs = CompiledStep(_acc_step, {"acc": torch.zeros(8)}, device="cpu")
    acc = torch.zeros(8)
    for i, b in enumerate(bufs):
        (out,) = cs(b)
        acc, want = _acc_eager(acc, b)
        assert torch.equal(out, want)
        (sig,) = cs._sigs.values()
        assert cs.binds == min(i + 1, compiled.BIND_CAP)
        assert cs.copies == max(0, i + 1 - compiled.BIND_CAP)
        assert len(sig.runs) == min(i + 1, compiled.BIND_CAP + 1)
    (out,) = cs(bufs[0])  # a bound buffer is still read in place
    acc, want = _acc_eager(acc, bufs[0])
    assert torch.equal(out, want) and cs.copies == 2 and cs.binds == compiled.BIND_CAP


def test_an_input_of_the_steps_own_memory_is_copied():
    """A previous output fed back in, and a (donated) state leaf, are
    copied, never bound, and give what the eager step gives."""
    cs = CompiledStep(_acc_step, {"acc": torch.ones(8)}, device="cpu")
    acc = torch.ones(8)
    (out,) = cs(torch.arange(8, dtype=torch.float32))
    acc, want = _acc_eager(acc, torch.arange(8, dtype=torch.float32))
    assert torch.equal(out, want) and (cs.binds, cs.copies) == (1, 0)
    fed = out.clone()
    (out,) = cs(out)  # a previous output
    acc, want = _acc_eager(acc, fed)
    assert torch.equal(out, want) and (cs.binds, cs.copies) == (1, 1)
    leaf = cs.state["acc"]  # the live state buffer (donated)
    fed = leaf.clone()
    (out,) = cs(leaf)
    acc, want = _acc_eager(acc, fed)
    assert torch.equal(out, want) and (cs.binds, cs.copies) == (1, 2)
    assert torch.equal(cs.state["acc"], acc)


def test_the_bind_span_carries_bytes_and_count():
    a, b = torch.ones(8), torch.zeros(8)
    cs = CompiledStep(_acc_step, {"acc": torch.zeros(8)}, device="cpu")
    timing._recorder.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for x in (a, b, a):
                (out,) = cs(x)
            cs(out)  # a previous output: copied
        spans = timing.recorded()
    finally:
        timing._recorder.clear()
    binds = [s for s in spans if s.name == "compiled.bind"]
    copies = [s for s in spans if s.name == "compiled.inputs"]
    assert [(s.nbytes, s.count) for s in binds] == [(32, 1), (32, 2), (32, 2), (0, 2)]
    assert [s.nbytes for s in copies] == [0, 0, 0, 32]
    assert all(s.parent.name == "compiled.call" for s in binds + copies)
