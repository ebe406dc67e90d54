"""ShardedChannelizer — the config-5 channelizer over one axis of the mesh
(counterpart of ``radioframe/shard/channelizer.py``; BASELINE config 5 on a
mesh). One wideband block is split in time along ``axis``: rank d holds
samples [d*T_local, (d+1)*T_local). Every rank calls ``step`` with its
slice and the global (M,) modes; ``gather`` joins the ranks' outputs into
the unsharded chain's global audio and aux.

Two formulations, chosen statically as the reference chooses them:

SINGLE-PASS (``fuse_single_pass``): each rank runs K5 over all M channels of
its time slice with the AGC off, and no all_to_all. The only full-rate
collective is a K*M-sample causal halo, one frame more than the PFB needs,
so that ranks d > 0 rebuild wideband frame -1's channel plane (a K3 launch
on that one frame) and seed their AM-envelope and NFM lookbacks exactly.
The sequential carries are completed across ranks on O(M) vectors
(``shard/halo.py``):
  - AM DC block: zero-seeded in the kernel, the entering carry from an
    affine chain over the ranks' final values, applied to the audio as the
    rank-1 fixup y += pole^(f+1) carry_in;
  - AGC release, attack and gain in torch through the cross-shard scans, or
    under "emit_env" the kernel's zero-entering release env completed with
    one elementwise max;
  - CW DDS: rank d starts its oscillator at cw_acc + word*(d*F_local), in
    wrapping int32.
Audio comes out split in time; the state is replicated and equal to the
unsharded chain's tree. Tiers (``one_mode``):
  - "defer" at D = 1 (unless ``force_general``): the unsharded chain as it is;
  - "emit_env" when AM is statically disabled and the release guard holds;
  - "xla" otherwise (the reference's name: the completion runs outside the
    kernel, here in torch).

TWO-KERNEL (otherwise): causal halo, the PFB of the local slice (K3 planes,
or ``ops/pfb.py``), ``all_to_all`` (channels split D ways, frames joined),
then the back end on the rank's M/D channels over the whole block: K4 with
its own M/D-channel instance, or the dense demod bank and ``AgcBank``
(SAM, and hang AGC, whose history then needs no halo). Audio comes out
split in channels and the per-channel state is the rank's slice.

The port's kernels work in channel order, so none of the reference's
native-order shuffles is needed; its ``% 128`` gates and ``MAX_GRID``
chunking are not carried.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from radioframe_torch.kernels.channelizer_one import FusedChannelizerOne
from radioframe_torch.kernels.demod_agc import FusedDemodAgc
from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.ops.spectrum import Spectrum
from radioframe_torch.pipelines.channelizer import ChannelizerChain, fused_backend_apply
from radioframe_torch.shard.halo import (affine_carry_chain, causal_halo, last_shard_value,
                                         sharded_affine_scan, sharded_maxdecay_complete,
                                         sharded_maxdecay_scan)
from radioframe_torch.shard.mesh import P


class ShardedChannelizer:
    """A ChannelizerChain's block step, split in time along ``axis`` of
    ``mesh``. Ranks along the mesh's other axis run the same program on the
    same data."""

    def __init__(self, chain: ChannelizerChain, mesh, axis: str = "time",
                 force_general: bool = False):
        # force_general: the general single-pass form even at D = 1 (to price
        # and test the multi-rank program on one rank)
        self.chain = chain
        self.ax = mesh.axis(axis)
        D = self.ax.size
        cfg = chain.cfg
        self._raw_spec = None
        if cfg.emit_spectrum and cfg.spectrum_avg > 0.0:
            self._raw_spec = Spectrum(cfg.spectrum_nfft, 0.0).to(chain.device)
        en = cfg.enabled_modes if cfg.enabled_modes is not None else tuple(range(demod_op.SAM + 1))
        self.demod_kernel = None
        self.one_kernel = None
        self.one_mode = None
        if chain.one_kernel is not None:
            if D == 1 and not force_general:
                self.one_mode = "defer"
                self.one_kernel = chain.one_kernel
                return
            if chain.agc_bank.hist_len:
                raise ValueError(
                    "sharded fuse_single_pass has no hang AGC: the hang history halo can exceed "
                    "a time shard's local length; set hang_s=0 or use the two-kernel sharded "
                    "path (dense AGC, hang-capable)")

            def build(emit: bool) -> FusedChannelizerOne:
                return FusedChannelizerOne(
                    cfg.num_channels, cfg.taps_per_channel, cfg.fs_channel,
                    cfg.nfm_deviation_hz, wf_avg=cfg.waterfall_frame_avg, enabled=en,
                    dft_precision=cfg.dft_precision, apply_agc=False,
                    emit_env=emit).to(chain.device)

            emit = demod_op.AM not in en
            kern = build(emit)
            if emit and not kern.release_ok(chain.agc_bank._release_table):
                emit, kern = False, build(False)
            self.one_kernel = kern
            self.one_mode = "emit_env" if emit else "xla"
            return
        if cfg.num_channels % D:
            raise AssertionError(f"{cfg.num_channels} channels do not split over {D} ranks")
        if chain.demod_kernel is not None and not chain.agc_in_torch:
            # each rank owns M/D channels after the all_to_all: its own K4
            self.demod_kernel = FusedDemodAgc(
                cfg.num_channels // D, cfg.fs_channel, cfg.nfm_deviation_hz,
                wf_avg=cfg.waterfall_frame_avg, enabled=en)
            if not self.demod_kernel.release_ok(chain.agc_bank._release_table):
                # M/D channels give a larger frame-tile cap than the chain's K4,
                # so the chain's guard does not cover this one
                raise ValueError(
                    "sharded fuse_demod: AGC release too fast for the per-shard kernel's "
                    f"{self.demod_kernel.max_tf}-frame tiles; lengthen release_s or disable "
                    "fuse_demod")

    # -- layout ----------------------------------------------------------------

    @property
    def split_channels(self) -> bool:
        """True for the two-kernel forms: audio and per-channel state are
        split in channels; else in time (and the state replicated)."""
        return self.one_kernel is None

    def init_state(self) -> dict:
        """The global initial state (split it with ``mesh.shard_state``)."""
        return self.chain.init_state()

    def state_specs(self) -> dict:
        """The state tree's layout for ``mesh.shard_state``/``gather_state``.
        Single-pass forms: every leaf replicated, the hang history included
        (hang runs only under "defer"). Two-kernel forms: the per-channel
        leaves, the hang history too, split along the axis."""
        cfg = self.chain.cfg
        hang = self.chain.agc_bank.hist_len > 0
        if not self.split_channels:
            return {"pfb": P(None, None),
                    "demod": {"cw_phase": P(None), "am_dc": P(None, None), "nfm_last": P(None),
                              "sam_dc": P(None, None), "sam_carrier": P(None, None)},
                    "agc": {"hist": P(None, None) if hang else (), "env": P(None),
                            "lpf": P(None)},
                    "spec": ()}
        a = self.ax.name
        has_spec = cfg.emit_spectrum and not cfg.waterfall_from_pfb
        return {"pfb": P(None, None),
                "demod": {"cw_phase": P(a), "am_dc": P(None, a), "nfm_last": P(a),
                          "sam_dc": P(None, a), "sam_carrier": P(None, a)},
                "agc": {"hist": P(a, None) if hang else (), "env": P(a), "lpf": P(a)},
                "spec": P(None, None) if has_spec else ()}

    def gather(self, audio, aux):
        """This rank's step outputs -> the unsharded chain's global audio (M,
        F) and aux, on every rank (collectives over the axis)."""
        ax = self.ax
        if self.one_mode == "defer":
            return audio, aux
        join = lambda t, dim: torch.cat(list(ax.all_gather(t)), dim=dim)  # noqa: E731
        cfg = self.chain.cfg
        if not self.split_channels:  # time-split audio and waterfall lines
            return join(audio, 1), {"channel_power": aux["channel_power"],
                                    "waterfall": join(aux["waterfall"], 0)}
        out = {"channel_power": join(aux["channel_power"], 0)}
        if "waterfall" in aux:
            if cfg.waterfall_from_pfb:  # channel-split lines; the global fftshift
                out["waterfall"] = torch.roll(join(aux["waterfall"], 1),
                                              cfg.num_channels // 2, dims=-1)
            else:  # Spectrum lines, split in time
                out["waterfall"] = join(aux["waterfall"], 0)
        return join(audio, 0), out

    # -- the block step --------------------------------------------------------

    def step(self, state, wideband, mode):
        """(state (this rank's, ``state_specs``), wideband (T_local,) complex
        time slice, mode (M,) global) -> (state', audio, aux), this rank's
        part (``gather`` joins them)."""
        if self.one_mode == "defer":
            return self.chain.step(state, wideband, mode)
        T = wideband.shape[-1]
        if T % self.chain.min_block:
            raise AssertionError(
                f"sharded block length {T * self.ax.size} must be a multiple of "
                f"D*min_block = {self.ax.size * self.chain.min_block}")
        if self.one_kernel is not None:
            return self._step_one(state, wideband, mode)
        return self._step_two(state, wideband, mode)

    def _lookback_plane(self, halo):
        """Channel plane (re, im) of wideband frame -1 from the K*M-sample
        halo (frames -K..-1): K3 on that one frame, the first (K-1)*M samples
        its tail."""
        H = (self.chain.pfb.K - 1) * self.chain.cfg.num_channels
        (yr, yi), _ = self.chain.pfb.call_planes(halo[None, :H], halo[None, H:])
        return yr[0], yi[0]

    def _step_one(self, state, wideband, mode):
        chain, cfg, ax = self.chain, self.chain.cfg, self.ax
        kern = self.one_kernel
        M, K = cfg.num_channels, chain.pfb.K
        D, d = ax.size, ax.index
        x = wideband[None, :]
        F_loc = x.shape[1] // M
        # the block carry stays the (K-1)*M PFB tail: rank 0's extra frame is
        # zeros and unused (it seeds from the block's demod state)
        carry2 = torch.cat([torch.zeros((1, M), dtype=x.dtype, device=x.device), state["pfb"]],
                           dim=-1)
        xp, new_carry2 = causal_halo(x, carry2, K * M, ax)
        pfb_tail = new_carry2[:, M:]
        halo = xp[0, :K * M]
        d_st, a_st = state["demod"], state["agc"]
        if d == 0:
            am_x, nfm_r, nfm_i = d_st["am_dc"][0], d_st["nfm_last"].real, d_st["nfm_last"].imag
        else:
            nfm_r, nfm_i = self._lookback_plane(halo)
            am_x = torch.sqrt(nfm_r * nfm_r + nfm_i * nfm_i)
        z = torch.zeros_like(am_x)
        # row 1 (AM y) zero-seeded on every rank, completed below; row 4
        # zero-seeded: the emit_env kernel scans the release from zero
        st_in = torch.stack([am_x, z, nfm_r, nfm_i, z, z, z])
        cw_word = torch.full((M,), chain.cw_tone_word, dtype=torch.int32, device=x.device)
        cw_acc = nco.wrap_i32(d_st["cw_phase"].to(torch.int64) + chain.cw_tone_word * d * F_loc)
        rel, al, tgt, mg = chain.agc_bank.per_channel(mode)
        planes = torch.view_as_real(x[0])
        outs = kern.call_planes(halo[None, M:], planes[:, 0], planes[:, 1], mode, cw_word,
                                cw_acc, rel, al, tgt, mg, st_in)
        audio_fm, _, wfp, st_out = outs[:4]
        release = chain.agc_bank._release_table
        am_on = demod_op.AM in kern.en
        am_dc = d_st["am_dc"]  # passed through where AM is off, as the kernel does
        if am_on:
            pole = demod_op.DC_POLE
            my_in, am_y_fin = affine_carry_chain(st_out[1], pole ** F_loc, d_st["am_dc"][1], ax)
            dcpow = torch.from_numpy(pole ** np.arange(1, F_loc + 1, dtype=np.float64)).to(
                device=x.device, dtype=torch.float32)
            audio_fm = audio_fm + torch.where((mode == demod_op.AM)[None, :],
                                              dcpow[:, None] * my_in[None, :], 0.0)
            am_dc = torch.stack([last_shard_value(st_out[0], ax), am_y_fin])
        audio = audio_fm.T  # (M, F_loc)
        if self.one_mode == "emit_env":  # one elementwise max, no full-rate scan
            env_r, env_fin = sharded_maxdecay_complete(rel, outs[4].T, a_st["env"], ax,
                                                       a_table=release, a_index=mode)
        else:
            env_r, env_fin = sharded_maxdecay_scan(rel, torch.abs(audio), a_st["env"], ax,
                                                   a_table=release, a_index=mode)
        if chain.agc_bank._alpha_table.any():
            env, lpf_fin = sharded_affine_scan(al, (1.0 - al)[:, None] * env_r, a_st["lpf"], ax,
                                               a_table=chain.agc_bank._alpha_table)
        else:  # instant attack everywhere: the one-pole is identity
            env, lpf_fin = env_r, env_fin
        gain = torch.minimum(mg[:, None], tgt[:, None] / torch.clamp_min(env, 1e-9))
        audio = torch.where((mode == demod_op.NFM)[:, None], audio, audio * gain)
        db = 10.0 * torch.log10(torch.clamp_min(wfp, 1e-24))
        aux = {"channel_power": ax.psum(st_out[6]) / (F_loc * D),
               "waterfall": torch.roll(db, M // 2, dims=-1)}
        nfm_last = d_st["nfm_last"]  # passed through where NFM is off, as the kernel does
        if demod_op.NFM in kern.en:
            nfm_last = torch.complex(last_shard_value(st_out[2], ax),
                                     last_shard_value(st_out[3], ax))
        new_demod = {
            "cw_phase": nco.wrap_i32(d_st["cw_phase"].to(torch.int64)
                                     + chain.cw_tone_word * F_loc * D),
            "am_dc": am_dc, "nfm_last": nfm_last,
            "sam_dc": d_st["sam_dc"], "sam_carrier": d_st["sam_carrier"]}
        new_agc = {"hist": (), "env": env_fin, "lpf": lpf_fin}
        new_state = {"pfb": pfb_tail, "demod": new_demod, "agc": new_agc, "spec": state["spec"]}
        return new_state, audio.contiguous(), aux

    def _step_two(self, state, wideband, mode):
        chain, cfg, ax = self.chain, self.chain.cfg, self.ax
        M = cfg.num_channels
        Ml = M // ax.size
        mode = mode[ax.index * Ml:(ax.index + 1) * Ml]  # this rank's channels
        x = wideband[None, :]
        H = (chain.pfb.K - 1) * M
        xp, pfb_carry = causal_halo(x, state["pfb"], H, ax)
        spec_prev = state["spec"]
        if self.demod_kernel is not None:
            # K3's planes are resharded as they are: the (M, F) complex
            # matrix is never formed
            (yr, yi), _ = chain.pfb.call_planes(xp[:, :H], x)
            planes = ax.all_to_all(torch.stack([yr, yi]), 2, 1)  # (2, F, M/D)
            audio_fm, power_sum, wfp, demod_state, agc_state = fused_backend_apply(
                functools.partial(self.demod_kernel, planes[0], planes[1]), chain.agc_bank,
                chain.cw_tone_word, state["demod"], state["agc"], mode, planes.shape[1])
            audio = audio_fm.T.contiguous()
            # (F/avg, M/D) lines, rolled by ``gather`` after the join
            aux = {"channel_power": power_sum / planes.shape[1],
                   "waterfall": 10.0 * torch.log10(torch.clamp_min(wfp, 1e-24))}
        else:
            chans, _ = chain.pfb(xp[:, :H], x)
            chans = ax.all_to_all(chans[0], 0, 1)  # (M/D, F): whole streams of M/D channels
            cw_word = torch.full((Ml,), chain.cw_tone_word, dtype=torch.int32,
                                 device=chans.device)
            audio, demod_state = demod_op.bank_apply(
                state["demod"], chans, mode, cw_word, cfg.fs_channel, cfg.nfm_deviation_hz,
                enabled=cfg.enabled_modes)
            agc_audio, agc_state, _ = chain.agc_bank(state["agc"], audio, mode)
            audio = torch.where((mode == demod_op.NFM)[:, None], audio, agc_audio)
            aux = {"channel_power": torch.mean(chans.real ** 2 + chans.imag ** 2, dim=-1)}
            if cfg.emit_spectrum:
                if cfg.waterfall_from_pfb:
                    A = cfg.waterfall_frame_avg
                    p = chans.real ** 2 + chans.imag ** 2
                    pa = p.reshape(Ml, -1, A).mean(dim=-1)
                    aux["waterfall"] = (10.0 * torch.log10(torch.clamp_min(pa, 1e-24))).T
                elif self._raw_spec is not None:
                    # EMA lines: raw dB lines here, the EMA completed across ranks
                    db, _ = self._raw_spec(state["spec"], x)  # (1, F_spec_loc, nfft)
                    _, Fl, nf = db.shape
                    b = (1.0 - cfg.spectrum_avg) * db[0].T
                    lines, prev = sharded_affine_scan(cfg.spectrum_avg, b,
                                                      state["spec"].reshape(nf), ax)
                    spec_prev = prev.reshape(1, nf)
                    aux["waterfall"] = lines.T
                else:
                    lines, _ = chain.spectrum(state["spec"], x)
                    spec_prev = last_shard_value(lines[:, -1, :], ax)
                    aux["waterfall"] = lines[0]
        new_state = {"pfb": pfb_carry, "demod": demod_state, "agc": agc_state,
                     "spec": spec_prev}
        return new_state, audio, aux
