"""Chain state and parameters carried between the reference and the port.

Signal chains have no trained weights: their parameters are host-built
numpy arrays (taps, polyphase weights, filter responses, AGC tables) and
their carried state is a tree of dicts and tuples whose leaves are arrays,
with ``()`` for a disabled feature. These helpers move both as numpy, so
the port never touches a JAX object. The receive chain's, the transmit
chain's, the duplex chain's ({"rx": ..., "tx": ...}) and the channelizer's
state trees all carry over as they are: the port keeps the reference's
keys, leaves and channel order.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {np.dtype(np.complex64): torch.complex64, np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32}


def state_from_numpy(tree, device):
    """Reference state (numpy leaves: complex64, int32 or float32; ``()`` for
    disabled features) -> the port's state on ``device``."""
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"unexpected state leaf dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def state_to_numpy(state):
    """The port's state -> the same tree with numpy leaves (tensor leaves
    copied to the host; numpy leaves as they are)."""
    if isinstance(state, dict):
        return {k: state_to_numpy(v) for k, v in state.items()}
    if isinstance(state, (tuple, list)):
        return tuple(state_to_numpy(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().numpy()
    return np.asarray(state)


def load_reference_params(chain, params: dict) -> None:
    """Copy the reference chain's parameters into ``chain``'s buffers.

    ``params`` keys: "stage_taps" (list, one taps array per stage), the
    fused front end's padded polyphase taps as the reference names them
    ("w1" and "w2" at depth 2; at depth 1 its single table, stage 1's, is
    "w2" and goes into K2's ``w1``), "H" (the OLS bank's (K, nfft)
    responses) and "release", "alpha", "target", "max_gain" (the AGC's
    per-mode tables)."""
    stage_taps = params["stage_taps"]
    if len(stage_taps) != len(chain.decimators):
        raise ValueError(f"{len(stage_taps)} stage taps for {len(chain.decimators)} stages")
    with torch.no_grad():
        for dec, taps in zip(chain.decimators, stage_taps):
            dec.set_taps(taps)
        chain._stage_taps = [np.asarray(t) for t in stage_taps]
        if chain.fused_stages == 2:
            for name in ("w1", "w2"):
                _copy(getattr(chain.fused, name), params[name])
        elif chain.fused_stages == 1:
            _copy(chain.fused.w1, params["w2"])
        _copy(chain.mode_bank._H, params["H"])
        chain.agc_bank.set_tables(**{k: params[k] for k in
                                     ("release", "alpha", "target", "max_gain")})


def load_channelizer_params(chain, params: dict) -> None:
    """Copy the reference ``ChannelizerChain``'s parameters into a port
    ``ChannelizerChain``: "h" (the (K, M) prototype rows ``_h``, into every
    module of the chain that holds them) and "release", "alpha", "target",
    "max_gain" (the AGC's per-mode tables)."""
    with torch.no_grad():
        for module in (chain.pfb, chain.one_kernel):
            if module is not None:
                _copy(module.h, params["h"])
        chain.agc_bank.set_tables(**{k: params[k] for k in
                                     ("release", "alpha", "target", "max_gain")})


def load_tx_params(chain, params: dict) -> None:
    """Copy the reference ``TxChain``'s parameters into a port ``TxChain``:
    "ssb_H" (the SSB filter's response), "interp_w" (one (J+1, L) polyphase
    matrix per interpolator), "eq" (one (A, B, b0) per mic-EQ section, or
    none without the EQ), and the floats "comp_decay" and "fm_k"."""
    if len(params["interp_w"]) != len(chain.interps):
        raise ValueError(f"{len(params['interp_w'])} polyphase matrices for "
                         f"{len(chain.interps)} interpolators")
    sections = chain.mic_eq.sections if chain.mic_eq is not None else ()
    eq = params.get("eq", ())
    if len(eq) != len(sections):
        raise ValueError(f"{len(eq)} EQ sections for a chain with {len(sections)}")
    with torch.no_grad():
        _copy(chain.ssb_bpf._H, params["ssb_H"])
        for ip, w in zip(chain.interps, params["interp_w"]):
            _copy(ip.w, w)
        for bq, (A, B, b0) in zip(sections, eq):
            _copy(bq.A, A)
            _copy(bq.B, B)
            bq.b0.fill_(float(np.float32(b0)))
    chain.comp_decay = float(params["comp_decay"])
    chain.fm_k = float(params["fm_k"])


def _copy(buf: torch.Tensor, arr) -> None:
    src = torch.from_numpy(np.ascontiguousarray(arr)).to(buf.dtype)
    if src.shape != buf.shape:
        raise ValueError(f"parameter shape {tuple(src.shape)} != buffer {tuple(buf.shape)}")
    buf.copy_(src)
