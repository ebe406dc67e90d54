"""ShardedRxChain — the receive block program over a ("channel", "time")
mesh (counterpart of ``radioframe/shard/rx.py``; BASELINE config 3, the
sharded DDC with halo exchange).

  - ``channel`` axis: every op is batched over channels, so a channel slice
    needs no collective.
  - ``time`` axis: one contiguous IQ block is split across ranks. Causal
    FIR/CIC/OLS tails cross shard boundaries as halos from the left
    neighbour; the AGC and DC-block recursions finish with all_gather
    carry chains (``shard/halo.py``). The int32 DDS needs no communication:
    shard d derives its oscillator segment from the replicated phase word at
    offset d*T_local, bit-identical to the unsharded chain.

``step(state, iq_local, words_local, mode_local)`` is one rank's part, the
counterpart of the reference's shard_map body: this rank's (C/channel,
T/time) shard in, its local audio out. The state is the rank's channel
slice, replicated across time (``mesh.shard_state`` with ``state_specs``).

The front end follows the chain: the fused depth-1 front end (K2) with
either halo transport, the fused depth-2 front end (K1) with the ppermute
halo, or the NCO at its offset plus the decimators. With
``halo_transport="rdma"`` at depth 1 the halo rides K7 (``kernels/
halo_dma.py``): the put is enqueued, K2 runs on the local block with a zero
tail (the interior, which needs nothing from the neighbour), and the
receive, enqueued behind a wait on the card for the halo's flag, feeds
``FusedFrontend.boundary_correction``, which adds the tail's part to the
first J0 outputs; the host waits for none of it. The back end is the
composed ops (OLS bank, demod bank, AGC) whatever ``fuse_backend`` says, as
in the reference: K6 walks a whole block, and its carries cannot be
completed across shards. ``power_in`` is the ``psum`` over the time axis of
the fused kernel's input power sums (K2's interior reads the whole local
block); the dense front end takes a pass of its own.

The RX options cross the time axis with the reference's collectives: the
noise blanker's running power and the NFM de-emphasis are scans completed
across shards; the auto-notch's EMA takes the frame mean over the whole
block (a psum), the VAD's floor and the NR's estimate the minimum over it
(a pmin) and the NR the count of quiet frames (a psum), while the VAD flags
of each frame stay on the shard that holds it; the squelch's noise metric is
the mean |diff| over the whole block (a one-sample halo and a psum).
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.kernels.halo_dma import HaloDma, causal_halo_dma
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.ops.interference import frame_stats, frames
from radioframe_torch.ops.spectrum import Spectrum
from radioframe_torch.pipelines.rx_chain import OPTION_KEYS, RxChain
from radioframe_torch.shard.halo import (causal_halo, last_shard_value, sharded_affine_scan,
                                         sharded_biquad_cascade, sharded_maxdecay_scan)
from radioframe_torch.shard.mesh import P


def _halo_tail(x_local, carry, H: int, axis):
    """(prepend_tail (C, H), new_carry); the carry is replicated across time."""
    if H == 0:
        return x_local[..., :0], carry
    xp, new_carry = causal_halo(x_local, carry, H, axis)
    return xp[..., :H], new_carry


def _advance(acc, word, n: int) -> torch.Tensor:
    return nco.wrap_i32(acc.to(torch.int64) + word.to(torch.int64) * n)


class ShardedRxChain:
    """An RxChain's ops as one rank's block step on ``mesh``."""

    def __init__(self, chain: RxChain, mesh):
        self.chain = chain
        self.mesh = mesh
        self.ca, self.ta = mesh.axis("channel"), mesh.axis("time")
        self.halo = HaloDma(self.ta)  # K7 on the time axis (halo_transport="rdma")
        cfg = chain.cfg
        self._raw_spec = None
        if cfg.emit_spectrum and cfg.spectrum_avg > 0.0:
            self._raw_spec = Spectrum(cfg.spectrum_nfft, 0.0).to(chain.device)

    def close(self) -> None:
        """Free K7's buffers (a collective over the time axis)."""
        self.halo.close()

    def check(self) -> None:
        """Raise if a K7 exchange so far found a wrong sequence flag (waits
        for this rank's work; called once per block after the gathers)."""
        self.halo.check()

    # -- one rank's block step -------------------------------------------------

    def _front(self, state, iq, words):
        """NCO and decimators -> (x at the audio rate, decim carries, this
        rank's raw input power sum (C,), or None for the dense front end)."""
        chain, ta = self.chain, self.ta
        d, T_loc = ta.index, iq.shape[-1]
        if chain.fused is None:
            x = nco.mix_down_at(iq, words, state["nco"], d * T_loc)
            pwsum = None
            tails = []
            dec_rest = zip(chain.decimators, state["decim"])
        else:
            # the DDS phase is affine in the sample index: shard d offsets the
            # accumulator by word*d*T_loc; the halo carries RAW iq, mixed in
            # the kernel at its true global indices
            ff = chain.fused
            acc_d = _advance(state["nco"], words, d * T_loc)
            H = ff.H if chain.fused_stages == 1 else ff.H_carry
            if chain.cfg.halo_transport == "rdma" and chain.fused_stages == 1 and H:
                pending = self.halo.start(iq, H) if ta.size > 1 else None
                zero = torch.zeros((words.shape[0], H), dtype=torch.complex64, device=iq.device)
                # the interior: the whole local block, so its power sum too
                _, x, pwsum = ff.step({"acc": acc_d, "tail": zero}, iq, words, return_power=True)
                xp_h, carry0 = causal_halo_dma(iq, state["decim"][0], H, self.halo,
                                               pending=pending)
                x[:, : ff.J0] += ff.boundary_correction(acc_d, words, xp_h[..., :H])
            else:
                # depth 2 takes this path whatever the transport: the overlap
                # split applies to the single-stage kernel only
                prepend, carry0 = _halo_tail(iq, state["decim"][0], H, ta)
                _, x, pwsum = ff.step({"acc": acc_d, "tail": prepend}, iq, words,
                                      return_power=True)
            tails = [carry0]
            dec_rest = zip(chain.decimators[chain.fused_stages:], state["decim"][1:])
        # decimation stages: halo = L-1 input samples from the left neighbour
        for dec, carry in dec_rest:
            prepend, new_carry = _halo_tail(x, carry, dec.L - 1, ta)
            x, _ = dec(prepend, x)
            tails.append(new_carry)
        return x, tuple(tails), pwsum

    def _demod(self, st, sel, mode):
        """The demod bank across shards -> (audio (C, Ta_loc) f32, demod state)."""
        chain, cfg, ta = self.chain, self.chain.cfg, self.ta
        D, d = ta.size, ta.index
        Ta_loc = sel.shape[-1]
        en = (frozenset(range(demod_op.SAM + 1)) if cfg.enabled_modes is None
              else frozenset(map(int, cfg.enabled_modes)))
        m_sel = mode[:, None]
        audio = torch.zeros(sel.shape, dtype=torch.float32, device=sel.device)
        if en & {demod_op.SSB, demod_op.LSB}:
            mask = torch.zeros_like(m_sel, dtype=torch.bool)
            for code in (demod_op.SSB, demod_op.LSB):
                if code in en:
                    mask = mask | (m_sel == code)
            audio = audio + torch.where(mask, demod_op.demod_ssb(sel), 0.0)

        new_cw = st["cw_phase"]
        if demod_op.CW in en:
            cw_word = torch.full(mode.shape, chain.cw_tone_word, dtype=torch.int32,
                                 device=sel.device)
            y_cw = 2.0 * nco.mix_up_at(sel, cw_word, st["cw_phase"], d * Ta_loc).real
            new_cw = _advance(st["cw_phase"], cw_word, D * Ta_loc)
            audio = audio + torch.where(m_sel == demod_op.CW, y_cw, 0.0)

        new_am_dc = st["am_dc"]
        if demod_op.AM in en:
            env_am = torch.abs(sel).to(torch.float32)
            xprev_pre, new_am_xprev = _halo_tail(env_am, st["am_dc"][0][:, None], 1, ta)
            b = env_am - torch.cat([xprev_pre, env_am[:, :-1]], dim=-1)
            y_am, new_am_y = sharded_affine_scan(demod_op.DC_POLE, b, st["am_dc"][1], ta)
            new_am_dc = torch.stack([new_am_xprev[:, -1], new_am_y])
            audio = audio + torch.where(m_sel == demod_op.AM, y_am, 0.0)

        new_nfm_last = st["nfm_last"][:, None]
        if demod_op.NFM in en:
            prev_pre, new_nfm_last = _halo_tail(sel, st["nfm_last"][:, None], 1, ta)
            dd = sel * torch.conj(torch.cat([prev_pre, sel[:, :-1]], dim=-1))
            scale = float(np.float32(cfg.fs_audio / (2.0 * np.pi * cfg.nfm_deviation_hz)))
            y_nfm = torch.atan2(dd.imag, dd.real) * scale
            audio = audio + torch.where(m_sel == demod_op.NFM, y_nfm, 0.0)

        new_sam_dc, new_sam_carrier = st["sam_dc"], st["sam_carrier"]
        if demod_op.SAM in en:
            # global lag-1 autocorrelation (psum; shard 0 drops the term that
            # would reach before the block), coherent derotation, DC scan
            lag1_pre, _ = _halo_tail(sel, torch.zeros_like(sel[:, :1]), 1, ta)
            prods = sel * torch.conj(torch.cat([lag1_pre, sel[:, :-1]], dim=-1))
            if d == 0:
                prods[:, 0] = 0.0
            r1 = ta.psum(torch.sum(prods, dim=-1))
            w_c = torch.atan2(r1.imag, r1.real)
            n_loc = (d * Ta_loc + torch.arange(Ta_loc, dtype=torch.int32, device=sel.device))
            sam_phase = st["sam_carrier"][0][:, None] + w_c[:, None] * n_loc.to(torch.float32)
            derot = sel * torch.exp(-1j * sam_phase).to(sel.dtype)
            meanp = ta.psum(torch.sum(derot, dim=-1))
            meanp = meanp / torch.clamp_min(torch.abs(meanp), 1e-9)
            coherent = (derot * torch.conj(meanp)[:, None]).real.to(torch.float32)
            sam_prev_pre, new_sam_x = _halo_tail(coherent, st["sam_dc"][0][:, None], 1, ta)
            sam_b = coherent - torch.cat([sam_prev_pre, coherent[:, :-1]], dim=-1)
            y_sam, new_sam_y = sharded_affine_scan(demod_op.DC_POLE, sam_b, st["sam_dc"][1], ta)
            new_sam_dc = torch.stack([new_sam_x[:, -1], new_sam_y])
            two_pi = float(np.float32(2.0 * np.pi))
            new_sam_carrier = torch.stack([
                torch.remainder(st["sam_carrier"][0] + w_c * (D * Ta_loc), two_pi), w_c])
            audio = audio + torch.where(m_sel == demod_op.SAM, y_sam, 0.0)
        state = {"cw_phase": new_cw, "am_dc": new_am_dc, "nfm_last": new_nfm_last[:, -1],
                 "sam_dc": new_sam_dc, "sam_carrier": new_sam_carrier}
        return audio.to(torch.float32), state

    def _blank(self, st, x):
        """The noise blanker: its running power is a scan across shards."""
        nb = self.chain.nb
        p = torch.abs(x).to(torch.float32) ** 2
        avg, new = sharded_affine_scan(nb.pole, (1.0 - nb.pole) * p, st, self.ta)
        return nb.blank(x, p, avg), new

    def _spectral(self, state, sel, opt, aux):
        """Auto-notch, VAD and NR on the filtered signal; updates ``opt`` and
        puts the VAD flags (C, F_local) in ``aux``."""
        chain, ta = self.chain, self.ta
        if chain.notch:
            X = torch.fft.fft(frames(sel, chain.notch.nfft), dim=-1)
            mag = torch.abs(X).to(torch.float32)
            gmean = ta.psum(torch.sum(mag, dim=1)) / (mag.shape[1] * ta.size)
            sel, opt["notch"] = chain.notch.notch(X, state["notch"], gmean, torch.complex64)
        voice = None
        if chain.vad:
            energy, flat = frame_stats(sel, chain.vad.nfft)
            gmin = ta.pmin(torch.amin(energy, dim=-1))
            voice, opt["vad"] = chain.vad.flags(energy, flat, gmin, state["vad"])
            aux["vad_active"] = voice
        if chain.nr:
            nr = chain.nr
            X = torch.fft.fft(frames(sel, nr.nfft), dim=-1)
            mag = torch.abs(X).to(torch.float32)
            F_tot = mag.shape[1] * ta.size
            if voice is None:
                est = nr.estimate(state["nr"], ta.pmin(torch.amin(mag, dim=1)), F_tot)
            else:
                masked = torch.where(voice[:, :, None], float("inf"), mag)
                n_quiet = ta.psum(torch.sum((~voice).to(torch.int32), dim=1))
                est = nr.estimate(state["nr"], ta.pmin(torch.amin(masked, dim=1)), F_tot,
                                  quiet=n_quiet > 0)
            sel, opt["nr"] = nr.apply_gain(X, mag, est, torch.complex64), est
        return sel

    def _squelch(self, st, audio, mode):
        """The NFM squelch: the discriminator's HF noise as the mean |diff|
        over the whole block (a one-sample halo; shard 0 drops the term that
        would reach before the block)."""
        ta, threshold = self.ta, self.chain.cfg.squelch_threshold
        dpre, _ = _halo_tail(audio, torch.zeros_like(audio[:, :1]), 1, ta)
        diffs = torch.abs(audio - torch.cat([dpre, audio[:, :-1]], dim=-1))
        if ta.index == 0:
            diffs[:, 0] = 0.0
        hf = ta.psum(torch.sum(diffs, dim=-1)) / (ta.size * audio.shape[-1] - 1)
        new = 0.5 * st + 0.5 * hf  # demod_op.squelch's per-block one-pole
        is_open = new < threshold
        return torch.where((mode == demod_op.NFM)[:, None], audio * is_open[:, None], audio), new

    def _agc(self, st, audio, mode):
        """Hang sliding max (hist_len halo), cross-shard release max-decay and
        attack affine scans, per-mode constants gathered per channel."""
        bank, ta = self.chain.agc_bank, self.ta
        mag = torch.abs(audio).to(torch.float32)
        xp, hist_carry = causal_halo(mag, st["hist"], bank.hist_len, ta)
        m_agc = bank.hang_select(xp, mag.shape[-1], mode)
        rel_c, al_c, _, _ = bank.per_channel(mode)
        env_r, new_env = sharded_maxdecay_scan(rel_c, m_agc, st["env"], ta)
        env, new_lpf = sharded_affine_scan(al_c, (1.0 - al_c)[:, None] * env_r, st["lpf"], ta)
        gain = bank.gain_from_env(env, mode)
        audio = torch.where((mode == demod_op.NFM)[:, None], audio, audio * gain)
        return audio, {"hist": hist_carry, "env": new_env, "lpf": new_lpf}, gain

    def step(self, state, iq, words, mode):
        """(state, iq (C_loc, T_loc) c64, words (C_loc,) i32, mode (C_loc,) i32)
        -> (state, audio (C_loc, T_loc/decim) f32, aux)."""
        chain, cfg, ta = self.chain, self.chain.cfg, self.ta
        D, T_loc = ta.size, iq.shape[-1]
        if T_loc % chain.min_block:
            raise ValueError(f"local block length {T_loc} must be a multiple of "
                             f"{chain.min_block}")
        x, decim, pwsum = self._front(state, iq, words)
        opt = {k: state[k] for k in OPTION_KEYS}
        aux = {}
        if chain.nb:
            x, opt["nb"] = self._blank(state["nb"], x)
        # mode-filter OLS bank: halo at the audio rate, one response per channel
        prepend, bpf_carry = _halo_tail(x, state["bpf"], chain.mode_bank.L - 1, ta)
        sel, _ = chain.mode_bank.apply_selected(prepend, x, demod_op.filter_index(mode))
        sel = self._spectral(state, sel, opt, aux)
        audio, demod_state = self._demod(state["demod"], sel, mode)
        if chain.deemph is not None:  # dense, selected for the NFM channels
            de, opt["deemph"] = sharded_biquad_cascade(chain.deemph, state["deemph"], audio, ta)
            audio = torch.where((mode == demod_op.NFM)[:, None], de, audio)
        audio, agc_state, gain = self._agc(state["agc"], audio, mode)
        if cfg.squelch_enabled:
            audio, opt["squelch"] = self._squelch(state["squelch"], audio, mode)

        if pwsum is None:  # the dense front end: a pass of its own
            pwsum = torch.sum(torch.abs(iq) ** 2, dim=-1)
        else:  # the fused kernel's sum, in raw input units
            pwsum = pwsum * chain.fused.input_scale ** 2
        pw = ta.psum(pwsum) / (D * T_loc)
        aux.update(agc_gain_last=last_shard_value(gain[:, -1], ta),
                   power_in=pw.to(torch.float32).expand(mode.shape))
        spec_prev = state["spec"]
        if cfg.emit_spectrum:
            if self._raw_spec is not None:
                # the EMA across frames crosses shards: an affine scan per bin
                db, _ = self._raw_spec(state["spec"], x)  # (C, F_loc, nfft)
                Cs, Fl, nf = db.shape
                b = (1.0 - cfg.spectrum_avg) * db.movedim(1, -1).reshape(Cs * nf, Fl)
                lines_flat, prev_flat = sharded_affine_scan(
                    cfg.spectrum_avg, b, state["spec"].reshape(Cs * nf), ta)
                lines = lines_flat.reshape(Cs, nf, Fl).movedim(-1, 1)
                spec_prev = prev_flat.reshape(Cs, nf)
            else:
                lines, _ = chain.spectrum(state["spec"], x)
                spec_prev = last_shard_value(lines[:, -1, :], ta)
            aux["spectrum"] = lines
        new_state = {
            "nco": _advance(state["nco"], words, D * T_loc),
            "decim": decim,
            "bpf": bpf_carry,
            "demod": demod_state,
            "agc": agc_state,
            "spec": spec_prev,
            **opt,
        }
        return new_state, audio, aux

    # -- layout ------------------------------------------------------------------

    def state_specs(self) -> dict:
        """The state tree's layout: each leaf's ``P`` names the dimension cut
        along the channel axis (dim 1 for the (2, C) demod rows); ``()`` for
        a disabled feature. Used by ``mesh.shard_state``/``gather_state``."""
        ca, chain = self.ca.name, self.chain
        n_decim = len(chain.decimators) - chain.fused_stages + (1 if chain.fused else 0)
        return {
            "nco": P(ca),
            "decim": tuple(P(ca, None) for _ in range(n_decim)),
            "bpf": P(ca, None),
            "demod": {"cw_phase": P(ca), "am_dc": P(None, ca), "nfm_last": P(ca),
                      "sam_dc": P(None, ca), "sam_carrier": P(None, ca)},
            "agc": {"hist": P(ca, None) if chain.agc_bank.hist_len else (),
                    "env": P(ca), "lpf": P(ca)},
            "spec": P(ca, None),
            "nb": P(ca) if chain.nb else (),
            "nr": P(ca, None) if chain.nr else (),
            "vad": P(ca) if chain.vad else (),
            "notch": P(ca, None) if chain.notch else (),
            "squelch": P(ca) if chain.cfg.squelch_enabled else (),
            "deemph": (tuple(P(ca, None) for _ in chain.deemph.sections)
                       if chain.deemph is not None else ()),
        }

    def init_state(self, num_channels: int) -> dict:
        """The global initial state (split it with ``mesh.shard_state``)."""
        return self.chain.init_state(num_channels)
