"""K6 as the flagship's back end on the card (``-m card``; each test skips
without a CUDA card). This file imports no JAX, so that it runs where the
card is, without the suite's conftest:

    python -m pytest --noconftest -m card tests/test_torch_k6_card.py -q

- ``RxChain.step_back`` through K6 against the composed ops
  (``_step_back_composed``) at the flagship's shape, C = 128 and T =
  131,072, over 8 blocks from a cold start: audio within 2e-4 from block 1
  (NFM modulo fs/deviation = 19.2), the carry within 2e-4 of each row's
  scale (the AGC env without the NFM rows), the CW phase equal;
- K6's chain form (``call_chain``: tables, state and (C, Ta) audio read and
  written where they lie) bit-equal to its per-channel form (``forward``:
  the caller's gathers, packed carry and (Ta, C) audio, the kernel as it
  was before the chain form) on the same inputs, with and without attack;
- eight flagship ``Radio``s, each on a stream and a caller thread of its
  own, each launching the cooperative K6, finish their rounds.
"""

import threading

import numpy as np
import pytest
import torch

from radioframe_torch.api.radio import Radio
from radioframe_torch.core import presets
from radioframe_torch.core.config import AgcConfig
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.rx_chain import RxChain

C, T = 128, 131_072
FS = 1_536_000.0
PERIOD = 48_000.0 / 2500.0  # fs_audio / NFM deviation: an atan2 branch flip
TOL = 2e-4
NAMES = ("ssb", "cw", "am", "nfm")


@pytest.fixture
def card():
    """The CUDA device, or a skip when this machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def _flagship(**kw):
    return presets.wideband_1536k(C, fuse_frontend=True, fuse_frontend_depth=2, ols_hop=512,
                                  enabled_modes=(0, 1, 2, 3), **kw)


def _freqs():
    return np.linspace(-5e5, 5e5, C)


def _block(dev, k: int, seed: int = 7) -> torch.Tensor:
    """(C, T) complex64 block k of a continuous stream: at each row's tuning a
    tone 1 kHz up (an FM-modulated carrier on the NFM rows, whose
    discriminator needs a carrier), and complex noise 26 dB down."""
    n = torch.arange(k * T, (k + 1) * T, dtype=torch.float64, device=dev)[None] / FS
    f = torch.from_numpy(_freqs()).to(dev)[:, None]
    nfm = torch.from_numpy(np.arange(C) % 4 == demod_op.NFM).to(dev)[:, None]
    phase = 2 * np.pi * (f * n + torch.where(nfm, 0.8 * torch.sin(2 * np.pi * 1000.0 * n),
                                             1000.0 * n))
    g = torch.Generator(device=dev).manual_seed(seed * 1000 + k)
    noise = torch.complex(torch.randn((C, T), generator=g, device=dev),
                          torch.randn((C, T), generator=g, device=dev)) * 0.05
    return (torch.polar(torch.ones_like(phase), phase).to(torch.complex64) + noise)


def _row_err(a, b) -> float:
    """Largest difference of two (rows, C) tensors, each row relative to its
    scale (at least 1)."""
    scale = torch.clamp_min(b.abs().amax(dim=1), 1.0)
    return float(((a - b).abs().amax(dim=1) / scale).max())


@pytest.mark.card
def test_k6_back_end_matches_composed_ops(card):
    chain = RxChain(_flagship()).to(card)
    assert chain.back_path == "k6"
    k6 = chain.backend_kernel
    words = torch.from_numpy(nco.freq_word(_freqs(), FS)).to(card)
    modes_np = (np.arange(C) % 4).astype(np.int32)
    modes = torch.from_numpy(modes_np).to(card)
    keep = torch.from_numpy(modes_np != demod_op.NFM).to(card)
    fst, st_k = chain.split_state(chain.init_state())
    st_c = dict(st_k)
    before = k6.variant_launches["chain"]
    worst = 0.0
    with torch.no_grad():
        for blk in range(8):
            fst, x, pw = chain.step_front(fst, _block(card, blk), words)
            st_k, a_k, aux_k = chain.step_back(st_k, x, modes, pw)
            st_c, a_c, aux_c = chain._step_back_composed(st_c, x, modes, pw)
            assert a_k.shape == a_c.shape == (C, T // 32) and a_k.is_contiguous()
            d = (a_k - a_c).cpu().numpy()
            nfm = modes_np == demod_op.NFM
            d[nfm] -= PERIOD * np.round(d[nfm] / PERIOD)
            err = float(np.abs(d).max())
            dk, dc = st_k["demod"], st_c["demod"]
            carry = max(_row_err(dk["am_dc"], dc["am_dc"]),
                        _row_err(torch.view_as_real(dk["nfm_last"]).T,
                                 torch.view_as_real(dc["nfm_last"]).T),
                        _row_err(torch.stack([st_k["agc"]["env"], st_k["agc"]["lpf"]])[:, keep],
                                 torch.stack([st_c["agc"]["env"], st_c["agc"]["lpf"]])[:, keep]))
            gain = _row_err(aux_k["agc_gain_last"][keep][None],
                            aux_c["agc_gain_last"][keep][None])
            print(f"block {blk}: audio {err:.3g}, carry {carry:.3g}, last gain {gain:.3g}")
            if blk > 0:  # block 0: the AGC's cold start amplifies ulps
                assert err <= TOL, f"block {blk}: audio {err:.3g}"
                worst = max(worst, err)
            assert carry <= TOL, f"block {blk}: carry {carry:.3g}"
            assert torch.equal(dk["cw_phase"], dc["cw_phase"])
            assert torch.equal(st_k["bpf"], st_c["bpf"])
    assert k6.variant_launches["chain"] == before + 8
    print(f"K6 against the composed ops, blocks 1-7: audio {worst:.3g}")


@pytest.mark.card
@pytest.mark.parametrize("attack_s", [0.0, 0.002])
def test_chain_form_is_bit_equal_to_per_channel_form(card, attack_s):
    chain = RxChain(_flagship(agc=AgcConfig(attack_s=attack_s))).to(card)
    k6, ab = chain.backend_kernel, chain.agc_bank
    words = torch.from_numpy(nco.freq_word(_freqs(), FS)).to(card)
    modes = (torch.arange(C, device=card, dtype=torch.int32) * 5) % 6  # SAM reads AM's row
    cw = torch.full((C,), chain.cw_tone_word, dtype=torch.int32, device=card)
    fst, bst = chain.split_state(chain.init_state())
    with torch.no_grad():
        for blk in range(3):
            fst, x, _ = chain.step_front(fst, _block(card, blk, seed=11), words)
            d, agc = bst["demod"], bst["agc"]
            rel, al, tgt, mg = ab.per_channel(modes)
            st_in = torch.stack([d["am_dc"][0], d["am_dc"][1], d["nfm_last"].real,
                                 d["nfm_last"].imag, agc["env"], agc["lpf"],
                                 torch.zeros_like(agc["env"])])
            h_sel = chain.mode_bank._H.index_select(
                0, demod_op.filter_index(modes).to(torch.int64))
            a_p, st_p, tail_p = k6(bst["bpf"], x, h_sel, modes, cw, d["cw_phase"], rel, al, tgt,
                                   mg, st_in)
            plan_p = k6.last_plan
            a_c, tail_c, d_c, agc_c, gain_c = k6.call_chain(
                bst["bpf"], x, chain.mode_bank._H, modes,
                (ab.release, ab.alpha, ab.target, ab.max_gain), chain.cw_tone_word, d, agc)
            assert k6.last_plan == plan_p
            assert torch.equal(a_c, a_p), f"block {blk}: audio"
            assert torch.equal(tail_c, tail_p)
            assert torch.equal(d_c["am_dc"], st_p[0:2])
            assert torch.equal(torch.view_as_real(d_c["nfm_last"]).T, st_p[2:4])
            assert torch.equal(agc_c["env"], st_p[4]) and torch.equal(agc_c["lpf"], st_p[5])
            assert torch.equal(gain_c, torch.minimum(mg, tgt / torch.clamp_min(st_p[5], 1e-9)))
            assert torch.equal(d_c["cw_phase"], nco.wrap_i32(
                d["cw_phase"].to(torch.int64) + cw.to(torch.int64) * x.shape[-1]))
            bst = {**bst, "bpf": tail_c, "demod": d_c, "agc": agc_c}


@pytest.mark.card
def test_eight_radios_on_eight_streams_finish_their_rounds(card):
    radios = []
    for r in range(8):
        radio = Radio(_flagship(), device=card)
        for c, f in enumerate(_freqs()):
            radio.tune(c, float(f))
            radio.set_mode(c, NAMES[c % 4])
        radios.append(radio)
    assert all(r.chain.back_path == "k6" for r in radios)
    blocks = [_block(card, r, seed=13).cpu().numpy() for r in range(8)]
    out: dict = {}
    errors = []

    def serve(r):
        try:
            for _ in range(3):
                out[r] = radios[r].process(blocks[r])
        except Exception as e:  # noqa: BLE001 - reported by the test
            errors.append((r, e))

    threads = [threading.Thread(target=serve, args=(r,), daemon=True) for r in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a receiver did not finish its rounds"
    assert not errors, errors
    torch.cuda.synchronize(card)
    assert sorted(out) == list(range(8))
    assert all(np.shape(a) == (C, T // 32) and np.isfinite(np.asarray(a)).all()
               for a in out.values())
    streams = {r._stager.stream.cuda_stream for r in radios}
    assert len(streams) == 8
    assert all(r.chain.backend_kernel.variant_launches["chain"] >= 3 for r in radios)
