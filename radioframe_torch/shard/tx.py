"""ShardedTxChain — the DUC transmit block program over a ("channel",
"time") mesh (counterpart of ``radioframe/shard/tx.py``).

The machinery of ``shard/rx.py`` in the adjoint direction: each rank holds
a time shard of the audio block; the DC block, the compressor's envelope
and the FM phase integrator (the affine scan with a = 1) are scans
completed across shards; the mic EQ is ``sharded_biquad_cascade``; the SSB
filter's and each interpolator's input tails are causal halos; the DDS NCO
runs at the shard's output-rate offset with no communication.

The modulator bank is ``TxChain.modulate``'s, all five branches: an LSB
channel sends the conjugate of its SSB signal, as the unsharded chain
does. (The reference's sharded form stacks four branches, so its LSB
channels read past the stack and send NaN.)
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.ops import demod as demod_op
from radioframe_torch.ops import nco
from radioframe_torch.pipelines.tx_chain import TWO_PI, TxChain
from radioframe_torch.shard.halo import (sharded_affine_scan, sharded_biquad_cascade,
                                         sharded_maxdecay_scan)
from radioframe_torch.shard.mesh import P
from radioframe_torch.shard.rx import _advance, _halo_tail


class ShardedTxChain:
    """A TxChain's ops as one rank's block step on ``mesh``: ``step(state,
    audio_local, words_local, mode_local)`` takes this rank's (C/channel,
    Ta/time) audio shard and returns its IQ shard (C/channel, Ta*L/time)."""

    def __init__(self, chain: TxChain, mesh):
        self.chain = chain
        self.mesh = mesh
        self.ca, self.ta = mesh.axis("channel"), mesh.axis("time")

    def step(self, state, audio, words, mode):
        chain, cfg, ta = self.chain, self.chain.cfg, self.ta
        D, d = ta.size, ta.index
        # speech processor: DC block (one-sample halo + scan), EQ, compressor
        xprev_pre, new_dc_x = _halo_tail(audio, state["dc"][0][:, None], 1, ta)
        b = audio - torch.cat([xprev_pre, audio[:, :-1]], dim=-1)
        a_dc, new_dc_y = sharded_affine_scan(demod_op.DC_POLE, b, state["dc"][1], ta)
        eq_state = state["eq"]
        if chain.mic_eq is not None:
            a_dc, eq_state = sharded_biquad_cascade(chain.mic_eq, state["eq"], a_dc, ta)
        env, new_comp = sharded_maxdecay_scan(chain.comp_decay, torch.abs(a_dc), state["comp"],
                                              ta)
        gain = torch.clamp_max(float(np.float32(cfg.compressor_target))
                               / torch.clamp_min(env, 1e-9),
                               float(np.float32(cfg.compressor_max_gain)))
        a = a_dc * gain
        # modulator bank
        ac = a.to(torch.complex64)
        pre, ssb_carry = _halo_tail(ac, state["ssb"], chain.ssb_bpf.L - 1, ta)
        y_ssb, _ = chain.ssb_bpf(pre, ac)
        phase, new_fm = sharded_affine_scan(1.0, chain.fm_k * a, state["fm_phase"], ta)
        x = chain.modulate(audio, a, y_ssb, phase, mode)
        # interpolation stages: halo = tin input samples from the left neighbour
        tails = []
        for ip, carry in zip(chain.interps, state["interp"]):
            pre, new_carry = _halo_tail(x, carry, ip.tin, ta)
            x, _ = ip(pre, x)
            tails.append(new_carry)
        # the TX NCO at this shard's output-rate offset
        T_out = x.shape[-1]
        iq = nco.mix_up_at(x, words, state["nco"], d * T_out)
        new_state = {
            "dc": torch.stack([new_dc_x[:, -1], new_dc_y]),
            "eq": eq_state,
            "comp": new_comp,
            "ssb": ssb_carry,
            "fm_phase": torch.remainder(new_fm, float(np.float32(TWO_PI))),
            "interp": tuple(tails),
            "nco": _advance(state["nco"], words, D * T_out),
        }
        return new_state, iq

    def state_specs(self) -> dict:
        """The state tree's layout (the reference's ``_state_specs``)."""
        ca, chain = self.ca.name, self.chain
        return {
            "dc": P(None, ca),
            "eq": (tuple(P(ca, None) for _ in chain.mic_eq.sections)
                   if chain.mic_eq is not None else ()),
            "comp": P(ca),
            "ssb": P(ca, None),
            "fm_phase": P(ca),
            "interp": tuple(P(ca, None) for _ in chain.interps),
            "nco": P(ca),
        }

    def init_state(self, num_channels: int | None = None) -> dict:
        """The global initial state (split it with ``mesh.shard_state``)."""
        return self.chain.init_state(num_channels)
