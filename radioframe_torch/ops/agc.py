"""AGC — attack / release / hang automatic gain control with per-mode
constants (counterpart of ``radioframe/ops/agc.py``).

Three vectorized stages, each equal to the golden per-sample definition
(``golden.model.agc_full``):

  1. hang    — sliding-window max of |x| over the hang window (van Herk /
               Gil-Werman: two ``torch.cummax`` passes, any window size);
  2. release — env_r[n] = max(m[n], decay * env_r[n-1]), a max-decay scan;
  3. attack  — env[n] = a*env[n-1] + (1-a)*env_r[n], an affine scan
               (a=0: instant attack).

Gain = clip(target / env, <= max_gain). Per-mode constants are (n_modes,)
buffers gathered by the runtime ``mode`` input.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from radioframe_torch.core import compiled
from radioframe_torch.ops.scans import (affine_const_ok, affine_scan, affine_scan_const,
                                        maxdecay_const_ok, maxdecay_scan,
                                        maxdecay_scan_const)


def release_decay(release_s: float, fs: float) -> float:
    """Per-sample decay for a given release time constant (seconds)."""
    return float(np.exp(-1.0 / (release_s * fs)))


def attack_alpha(attack_s: float, fs: float) -> float:
    """One-pole coefficient for the attack time constant (0 = instant)."""
    if attack_s <= 0.0:
        return 0.0
    return float(np.exp(-1.0 / (attack_s * fs)))


def hang_samples(hang_s: float, fs: float) -> int:
    """Hang time in whole samples at fs."""
    return max(0, int(round(hang_s * fs)))


def init_state(num_channels: int, device) -> torch.Tensor:
    return torch.zeros((num_channels,), dtype=torch.float32, device=device)


def apply(env0, x, decay: float, target: float = 1.0, max_gain: float = 1e4, eps: float = 1e-9):
    """Instant-attack / exp-release AGC. (env0 (C,), x (C, T)) -> (y, new_env, gain)."""
    mag = torch.abs(x).to(torch.float32)
    if maxdecay_const_ok([decay], mag.shape[-1]):
        env = maxdecay_scan_const(torch.full(mag.shape[:-1], decay, dtype=torch.float32,
                                             device=mag.device), mag, env0)
    else:
        env = maxdecay_scan(torch.full_like(mag, decay), mag, env0)
    gain = torch.clamp_max(float(np.float32(target)) / torch.clamp_min(env, float(np.float32(eps))),
                           float(np.float32(max_gain)))
    return x * gain.to(x.dtype), env[:, -1], gain


def sliding_max(xp, T: int, W: int):
    """m[t] = max(xp[..., t : t+W]) for t in [0, T); xp (..., T+W-1).

    Van Herk / Gil-Werman: pad to a multiple of W, one forward and one
    backward cummax per W-chunk; every window max is the max of one suffix
    and one prefix value — O(T), any window size (including W > T)."""
    if W == 1:
        return xp[..., -T:]
    P = xp.shape[-1]
    if P != T + W - 1:
        raise ValueError(f"sliding_max: history+block {P} != T + W - 1 = {T + W - 1}")
    P2 = -(-P // W) * W
    off = P2 - P
    x2 = torch.cat([xp.new_full(xp.shape[:-1] + (off,), -np.inf), xp], dim=-1)
    blocks = x2.reshape(x2.shape[:-1] + (P2 // W, W))
    pre = torch.cummax(blocks, dim=-1).values.reshape(x2.shape)   # max(chunk_start..i)
    suf = torch.flip(torch.cummax(torch.flip(blocks, (-1,)), dim=-1).values,
                     (-1,)).reshape(x2.shape)                       # max(i..chunk_end)
    # window [i, i+W-1] in x2 coords, i = off + t: max(S[i], R[i+W-1])
    return torch.maximum(suf[..., off: off + T], pre[..., off + W - 1:])


class AgcBank(nn.Module):
    """Per-mode attack/release/hang AGC over (C, T) audio blocks.

    Built from one AgcConfig per demod mode code (SSB/CW/AM/NFM/LSB/SAM);
    the buffers ``release``, ``alpha``, ``target``, ``max_gain`` and
    ``win_index`` are (n_modes,) tables gathered by the runtime mode input.
    Distinct hang windows are computed once each and selected per channel.

    State: {"hist": (C, Wmax-1) recent |audio| or () without hang, "env":
    (C,) release env, "lpf": (C,) attack-smoothed env}.

    The reference's ``AgcBank.apply`` is this module's call (``forward``):
    ``nn.Module.apply`` keeps its torch meaning."""

    def __init__(self, mode_cfgs, fs: float):
        super().__init__()
        self.n_modes = len(mode_cfgs)
        wins = [hang_samples(c.hang_s, fs) + 1 for c in mode_cfgs]  # window incl. current
        self.distinct_W = sorted(set(wins))
        self.Wmax = max(wins)
        self.hist_len = self.Wmax - 1  # == halo size under time sharding
        self.register_buffer("win_index", torch.tensor(
            [self.distinct_W.index(w) for w in wins], dtype=torch.int64))
        for name in ("release", "alpha", "target", "max_gain"):
            self.register_buffer(name, torch.zeros(self.n_modes, dtype=torch.float32))
        self._served: set[int] = set()  # the block lengths forward has run
        self.set_tables(
            release=[release_decay(c.release_s, fs) for c in mode_cfgs],
            alpha=[attack_alpha(c.attack_s, fs) for c in mode_cfgs],
            target=[c.target for c in mode_cfgs],
            max_gain=[c.max_gain for c in mode_cfgs])

    def set_tables(self, **tables) -> None:
        """Set the per-mode tables (release, alpha, target, max_gain). The
        host copies of release and alpha decide the static scan forms; a
        change of form for a block length already served invalidates the
        captured steps (``core/compiled.invalidate``), a change within the
        forms reaches them through the device tables."""
        before = {T: self.forms(T) for T in self._served}
        for name, values in tables.items():
            arr = np.asarray(values, np.float32)
            getattr(self, name).copy_(torch.from_numpy(arr))
            if name == "release":
                self._release_table = arr
            elif name == "alpha":
                self._alpha_table = arr
        if any(self.forms(T) != f for T, f in before.items()):
            compiled.invalidate()

    def forms(self, T: int) -> tuple[bool, bool, bool]:
        """The static scan forms for blocks of T samples: (constant-decay
        release, attack on, constant-coefficient attack)."""
        return (maxdecay_const_ok(self._release_table, T), bool(self._alpha_table.any()),
                affine_const_ok(self._alpha_table))

    def init_state(self, num_channels: int) -> dict:
        dev = self.release.device
        hist = (torch.zeros((num_channels, self.hist_len), dtype=torch.float32, device=dev)
                if self.hist_len else ())
        return {"hist": hist,
                "env": torch.zeros((num_channels,), dtype=torch.float32, device=dev),
                "lpf": torch.zeros((num_channels,), dtype=torch.float32, device=dev)}

    def hang_select(self, xp, T: int, mode):
        """Per-channel hang sliding max. xp (C, T+Wmax-1) = [hist | mag]."""
        if len(self.distinct_W) == 1:
            return sliding_max(xp, T, self.distinct_W[0])
        ms = torch.stack([sliding_max(xp[..., self.Wmax - W:], T, W)
                          for W in self.distinct_W])  # (nW, C, T)
        widx = self.win_index[mode.to(torch.int64)]
        return ms[widx, torch.arange(ms.shape[1], device=ms.device)]

    def per_channel(self, mode):
        """Gather (release, alpha, target, max_gain) as (C,) tensors."""
        m = mode.to(torch.int64)
        return self.release[m], self.alpha[m], self.target[m], self.max_gain[m]

    def gain_from_env(self, env, mode, eps: float = 1e-9):
        _, _, tgt, mg = self.per_channel(mode)
        return torch.minimum(mg[:, None], tgt[:, None] / torch.clamp_min(env, float(np.float32(eps))))

    def forward(self, state, audio, mode):
        """(state, audio (C, T) f32, mode (C,) int) -> (y, new_state, gain)."""
        T = audio.shape[-1]
        mag = torch.abs(audio).to(torch.float32)
        xp = torch.cat([state["hist"], mag], dim=-1) if self.hist_len else mag
        m = self.hang_select(xp, T, mode)
        rel, al, _, _ = self.per_channel(mode)
        # constant-coefficient fast paths: the static tables decide the
        # form, so any runtime mode mix is covered by the chosen path
        const_release, attack, const_attack = self.forms(T)
        self._served.add(T)
        if const_release:
            env_r = maxdecay_scan_const(rel, m, state["env"])
        else:
            env_r = maxdecay_scan(rel[:, None].expand(mag.shape), m, state["env"])
        if not attack:
            env = env_r  # instant attack everywhere: the one-pole is identity
        elif const_attack:
            env = affine_scan_const(al, (1.0 - al)[:, None] * env_r, state["lpf"])
        else:
            env = affine_scan(al[:, None].expand(mag.shape), (1.0 - al)[:, None] * env_r,
                              state["lpf"])
        gain = self.gain_from_env(env, mode)
        new_hist = xp[:, xp.shape[-1] - self.hist_len:] if self.hist_len else ()
        return audio * gain, {"hist": new_hist, "env": env_r[:, -1], "lpf": env[:, -1]}, gain
