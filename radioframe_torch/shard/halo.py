"""Halo exchange and cross-shard scan completion for time-sharded streams
(counterpart of ``radioframe/shard/halo.py``).

One contiguous IQ block is split across the mesh's time axis: shard d owns
samples [d*T_local, (d+1)*T_local) of the block, arrays are (C_local,
T_local), and the carried block state is replicated across the time axis.
Causal filter state (FIR, CIC, OLS tails) crosses shard boundaries as a
halo from the left neighbour; per-sample recursions (AGC envelope, DC
block) run as local scans from a zero carry, finished by a short chain over
an all_gather of each shard's final value.

``axis`` is this rank's ``mesh.Axis`` (the time axis), whose collectives
stand in for the reference's ``lax`` calls.
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.ops.scans import (affine_const_ok, affine_scan, affine_scan_const,
                                        maxdecay_const_ok, maxdecay_scan,
                                        maxdecay_scan_const)


def causal_from_recv(x_local, carry, recv, axis):
    """The causal halo from the left neighbour's tail ``recv``: shard 0
    prepends ``carry`` (the previous block's global tail); the value shard 0
    received over the wrap-around, the current block's global tail, becomes
    the next carry on every shard (a masked psum)."""
    is0 = axis.index == 0
    prepend = carry if is0 else recv
    new_carry = axis.psum(recv if is0 else torch.zeros_like(recv))
    return torch.cat([prepend, x_local], dim=-1), new_carry


def causal_halo(x_local, carry, H: int, axis):
    """Prepend each shard's left-neighbour tail (length H) to x_local.

    Returns (x_with_halo (C, H+T_local), new_carry (C, H))."""
    if H == 0:
        return x_local, carry
    if H > x_local.shape[-1]:
        raise ValueError(f"halo of {H} samples exceeds the local block of {x_local.shape[-1]}")
    tail = x_local[..., -H:]
    if axis.size == 1:
        return torch.cat([carry, x_local], dim=-1), tail
    return causal_from_recv(x_local, carry, axis.ppermute_right(tail), axis)


def last_shard_value(x_last_local, axis):
    """Broadcast the last time shard's value to all shards (replicated)."""
    if axis.size == 1:
        return x_last_local
    mine = axis.index == axis.size - 1
    return axis.psum(x_last_local if mine else torch.zeros_like(x_last_local))


def _carry_chain(local_final, A, carry, axis, combine):
    """Cross-shard completion of a zero-seeded recursion.

    ``local_final`` (C,) is this shard's final value computed from a ZERO
    entering carry; ``A`` (scalar or (C,)) the recursion's decay over one
    shard (a**T_local); ``combine(B_j, A*prev)`` folds the true entering
    value through shard j (affine: +, max-decay: max). Returns (my_in (C,),
    block_final (C,)): the true value entering this shard and the carry
    leaving the block, the same on every shard (the D-long chain is
    recomputed on each from one all_gather)."""
    if axis.size == 1:
        return carry, combine(local_final, A * carry)
    B = axis.all_gather(local_final)  # (D, C)
    ins = [carry]
    for j in range(axis.size):
        ins.append(combine(B[j], A * ins[j]))
    return ins[axis.index], ins[-1]


def affine_carry_chain(local_final, A, carry, axis):
    """Cross-shard chain for s[n] = a*s[n-1] + b[n] (see _carry_chain)."""
    return _carry_chain(local_final, A, carry, axis, lambda b, p: b + p)


def _as_tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def sharded_maxdecay_scan(a_const, v_local, carry, axis, a_table=None, a_index=None):
    """env[n] = max(a*env[n-1], v[n]) across the whole time-sharded block.

    a_const: scalar or (C,) per-channel decay; v_local (C, T_local); carry
    (C,) the global env entering the block. Returns (env_local, new_carry).
    ``a_table``: the static table the coefficients are drawn from; where the
    global-rescale bound holds for it at this T, the local scan takes the
    constant-coefficient cummax form. ``a_index``: the integer index the
    coefficients were gathered with (decay_pows)."""
    C, T = v_local.shape
    ac = _as_tensor(a_const, v_local)
    zero = torch.zeros((C,), dtype=v_local.dtype, device=v_local.device)
    if a_table is not None and maxdecay_const_ok(a_table, T):
        a_ch = ac if ac.dim() else torch.full((C,), float(ac), dtype=v_local.dtype,
                                              device=v_local.device)
        local_env = maxdecay_scan_const(a_ch, v_local, zero)
    else:
        a = (ac[:, None] if ac.dim() else ac).expand(v_local.shape)
        local_env = maxdecay_scan(a, v_local, zero)
    return sharded_maxdecay_complete(a_const, local_env, carry, axis,
                                     a_table=a_table, a_index=a_index)


def decay_pows(idx, a_table, T: int, dtype=torch.float32):
    """(C, T) decay powers a_table[idx]**(1..T) with no per-element
    transcendental: the (n_vals, T) rows are built on the host in float64
    from the small static table and selected by the integer index the
    caller gathered its coefficients with (exact by construction)."""
    tab = np.asarray(a_table, np.float64)
    pows = torch.from_numpy(tab[:, None] ** (1 + np.arange(T))[None, :]).to(dtype).to(idx.device)
    out = torch.zeros(tuple(idx.shape) + (T,), dtype=dtype, device=idx.device)
    for k in range(tab.shape[0]):
        out = torch.where((idx == k)[..., None], pows[k], out)
    return out


def sharded_maxdecay_complete(a_const, local_env, carry, axis, a_table=None, a_index=None):
    """Complete a ZERO-seeded local max-decay envelope (C, T_local) across
    shards. Returns (env, new_carry)."""
    C, T = local_env.shape
    ac = _as_tensor(a_const, local_env)
    if a_table is not None and a_index is not None and ac.dim():
        apow = decay_pows(a_index, a_table, T, local_env.dtype)
    else:
        n = 1 + torch.arange(T, dtype=local_env.dtype, device=local_env.device)
        apow = (ac[:, None] if ac.dim() else ac) ** n
    A = ac ** T
    my_in, fin = _carry_chain(local_env[:, -1], A, carry, axis, torch.maximum)
    return torch.maximum(local_env, my_in[:, None] * apow), fin


def sharded_biquad(bq, s0, x, axis):
    """One biquad section (``ops/biquad.Biquad``) across the time-sharded
    block: the local zero-state scan, an all_gather of each shard's final
    state vector, a sequential compose over the D shards (the same on every
    shard) for the state entering this one, then the local finish.

    Each shard's total map is A**T_local, built by the same scan from the
    same coefficients over the same length, so it is equal on every shard
    and only the vectors are gathered. s0 (C, 2) is the global entering
    state, x (C, T_local). Returns (y_local, new_state (C, 2))."""
    P, s = bq.scan(x)
    if axis.size == 1:
        return bq.finish(P, s, s0, x)
    a00, a01, a10, a11 = (p[-1] for p in P)
    finals = axis.all_gather(torch.stack([s[0][:, -1], s[1][:, -1]], dim=-1))  # (D, C, 2)
    ins = [s0]
    for j in range(axis.size):
        prev = ins[j]
        ins.append(torch.stack([a00 * prev[:, 0] + a01 * prev[:, 1] + finals[j, :, 0],
                                a10 * prev[:, 0] + a11 * prev[:, 1] + finals[j, :, 1]], dim=-1))
    y, _ = bq.finish(P, s, ins[axis.index], x)
    return y, ins[-1]


def sharded_biquad_cascade(cascade, state, x, axis):
    """``ops/biquad.BiquadCascade`` across the time-sharded block."""
    new_states = []
    for bq, st in zip(cascade.sections, state):
        x, st2 = sharded_biquad(bq, st, x, axis)
        new_states.append(st2)
    return x, tuple(new_states)


def sharded_affine_scan(a_const, b_local, carry, axis, a_table=None):
    """s[n] = a*s[n-1] + b[n] across the time-sharded block.

    a_const: scalar or (C,) per-channel coefficient; b_local (C, T_local);
    carry (C,). Returns (s_local, new_carry). ``a_table``: the static table
    that allows the chunked constant-coefficient local form
    (ops/scans.affine_scan_const) where its rescale bound holds."""
    C, T = b_local.shape
    ac = _as_tensor(a_const, b_local)
    n = 1 + torch.arange(T, dtype=b_local.dtype, device=b_local.device)
    apow = (ac[:, None] if ac.dim() else ac) ** n  # (T,) or (C, T)
    zero = torch.zeros((C,), dtype=b_local.dtype, device=b_local.device)
    if a_table is not None and affine_const_ok(a_table):
        a_ch = ac if ac.dim() else torch.full((C,), float(ac), dtype=b_local.dtype,
                                              device=b_local.device)
        local_s = affine_scan_const(a_ch, b_local, zero)
    else:
        a = (ac[:, None] if ac.dim() else ac).expand(b_local.shape)
        local_s = affine_scan(a, b_local, zero)
    A = ac ** T
    my_in, fin = affine_carry_chain(local_s[:, -1], A, carry, axis)
    return local_s + my_in[:, None] * apow, fin
