"""Probe the channelizer FFT (rf::fft) and the K7 exchange on one NVIDIA GPU.

    python3 probe_fft.py kernels [--tree DIR]   # one tree's kernel times
    python3 probe_fft.py variants               # K3 built from edited csrc/
    python3 probe_fft.py sharded                # four ranks: rdma vs ppermute

``kernels`` times K3 (base_b3, dft_only, pfb_only), K4, K5, K5's emit_env
variant at the sharded path's F_local=512, K6 and the FFT alone against
torch.fft.fft (M=4096 over 2048 frames, nfft=1024 over 1024 rows) at
chip_smoke.py's shapes, as CUDA-event medians and as device time
from torch.profiler, for the checkout at DIR (default: this one). Run it on
two checkouts in one call, in turns, to compare them on one card.
``variants`` times K3 and dft_only built from edited copies of csrc/
(dft_only's launch bound, for a third block per SM), with each build's
local-memory instructions counted from cuobjdump. ``sharded`` runs
the (1, 4) sharded slice with the K7 and the ppermute halo in turns, six
blocks each, and profiles one block of each on rank 0 (device busy time
and the host operations that hold it). Each prints the card's name and
power limit beside its numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn`` (every kernel it launches), from
    torch.profiler over ``n`` calls after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ks) / (1e3 * n)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def kernels(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import chip_smoke as CS
    from radioframe_torch.core import presets
    from radioframe_torch.kernels.channelizer_one import FusedChannelizerOne
    from radioframe_torch.kernels.pfb_dft import FusedPfbDft
    from radioframe_torch.ops.demod import filter_index
    from radioframe_torch.pipelines.channelizer import ChannelizerChain, _pack_backend_state
    from radioframe_torch.pipelines.rx_chain import RxChain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    wr = torch.randn(CS.CH_T, generator=g, device=dev)
    wi = torch.randn(CS.CH_T, generator=g, device=dev)
    fns = {}
    k3 = FusedPfbDft(CS.CH_M, CS.CH_K).to(dev)
    tail = k3.init_state(1)
    for v in ("base_b3", "dft_only", "pfb_only"):
        fns[f"K3 {v}"] = lambda v=v: k3._launch(tail, wr, wi, v)
    fns["torch.fft.fft M=4096"] = lambda p=torch.complex(wr, wi).reshape(-1, CS.CH_M): (
        torch.fft.fft(p, dim=-1))
    k10 = FusedPfbDft(1024, CS.CH_K).to(dev)
    n = 1024 * 1024
    fns["rf::fft nfft=1024"] = lambda: k10._launch(k10.init_state(1), wr[:n], wi[:n], "dft_only")
    fns["torch.fft.fft nfft=1024"] = lambda p=torch.complex(wr[:n], wi[:n]).reshape(1024, 1024): (
        torch.fft.fft(p, dim=-1))
    one = ChannelizerChain(presets.channelizer_61m44(CS.CH_M)).to(dev)
    mode = torch.arange(CS.CH_M, device=dev, dtype=torch.int32) % 4
    word = torch.full((CS.CH_M,), one.cw_tone_word, dtype=torch.int32, device=dev)
    consts = (mode, word, torch.zeros_like(word), *one.agc_bank.per_channel(mode))
    st0 = CS._carry0(CS.CH_M, dev)
    fns["K5"] = lambda: one.one_kernel.call_planes(tail, wr, wi, *consts, st0)
    k5e = FusedChannelizerOne(CS.CH_M, CS.CH_K, one.one_kernel.fs, one.one_kernel.nfm_deviation_hz,
                              wf_avg=16, enabled=(0, 1, 3, 4), apply_agc=False,
                              emit_env=True).to(dev)
    mode_e = torch.from_numpy(CS.EMIT_MODES.astype("int32")).to(dev)
    consts_e = (mode_e, word, torch.zeros_like(word), *one.agc_bank.per_channel(mode_e))
    n_loc = CS.CH_T // 4
    fns["K5 emit_env F=512"] = lambda: k5e.call_planes(tail, wr[:n_loc], wi[:n_loc], *consts_e,
                                                       st0)
    (yr, yi), _ = k3.step_planes(tail, wr, wi)
    k4 = ChannelizerChain(dataclasses.replace(one.cfg, fuse_single_pass=False)).to(dev).demod_kernel
    fns["K4"] = lambda: k4(yr, yi, *consts, st0)
    chain = RxChain(CS.slice_config()).to(dev)
    x = torch.complex(torch.randn((CS.C_FLAG, 4096), generator=g, device=dev),
                      torch.randn((CS.C_FLAG, 4096), generator=g, device=dev))
    modes = torch.arange(CS.C_FLAG, device=dev, dtype=torch.int32) % 4
    _, bst = chain.split_state(chain.init_state())
    d = bst["demod"]
    args = (bst["bpf"], x, chain.mode_bank._H.index_select(0, filter_index(modes).long()), modes,
            torch.full((CS.C_FLAG,), chain.cw_tone_word, dtype=torch.int32, device=dev),
            d["cw_phase"], *chain.agc_bank.per_channel(modes), _pack_backend_state(d, bst["agc"]))
    fns["K6"] = lambda: chain.backend_kernel(*args)
    with torch.no_grad():
        for name, fn in fns.items():
            print(f"[kernels {tree}] {name}: CUDA events {CS.median_ms(fn):.4f} ms, device "
                  f"{device_ms(fn):.4f} ms ({card()})", flush=True)


# dft_only's launch bound (its own kernel since K3 became a cluster walk, whose
# launch is one CTA an SM by design: the parent's "launch bound (256, 3)" and
# "two frames per block" edits of K3 no longer apply)
VARIANTS = {
    "shipped": [],
    "dft_only launch bound (256, 3)": [("pfb_dft.cu", "__launch_bounds__(512)\ndft_kernel",
                                        "__launch_bounds__(256, 3)\ndft_kernel")],
}


def variants() -> None:
    sys.path.insert(0, os.path.abspath("."))
    import torch

    import chip_smoke as CS
    import probe_channelizer as PC
    from radioframe_torch.kernels import _build
    from radioframe_torch.kernels import pfb_dft as K3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    wr = torch.randn(CS.CH_T, generator=g, device=dev)
    wi = torch.randn(CS.CH_T, generator=g, device=dev)
    k3 = K3.FusedPfbDft(CS.CH_M, CS.CH_K).to(dev)
    tail = k3.init_state(1)
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits) in enumerate(VARIANTS.items()):
            root = Path(tmp) / str(i)
            fn = PC.build_variant(root, edits, ((K3, "pfb_dft", "rf_pfb_dft"),))["pfb_dft"]
            sass = subprocess.run([str(cuobjdump), "-sass", str(root / "pfb_dft.so")],
                                  capture_output=True, text=True).stdout
            local = sum(line.count("LDL") + line.count("STL") for line in sass.splitlines())
            K3._kernel_fn = lambda f=fn: f
            y = k3._launch(tail, wr, wi, "base_b3")
            ref = y if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(y, ref))
            for v in ("base_b3", "dft_only"):
                f = lambda v=v: k3._launch(tail, wr, wi, v)  # noqa: E731
                print(f"[variants] {name} {v}: CUDA events {CS.median_ms(f):.4f} ms, device "
                      f"{device_ms(f):.4f} ms; local-memory instructions {local}; bit-equal to "
                      f"the shipped build: {same} ({card()})", flush=True)


def _sharded_rank(rank: int, world: int, device: str):
    import torch

    import chip_smoke as CS
    from radioframe_torch.api.radio import Radio
    from radioframe_torch.shard.mesh import make_mesh

    dev = torch.device(device)
    mesh = make_mesh(1, world, device=dev)
    freqs, modes, iq = CS._shard_inputs(CS.C_FLAG)
    out = []
    for transport in ("rdma", "ppermute", "rdma", "ppermute"):
        radio = Radio(CS.sharded_config(CS.C_FLAG, transport), device=dev, mesh=mesh)
        for ch in range(CS.C_FLAG):
            radio.tune(ch, float(freqs[ch]))
            radio.set_mode(ch, ("ssb", "cw", "am", "nfm")[modes[ch]])
        ms = []
        for b in range(6):
            t0 = time.perf_counter()
            radio.process(iq[b % len(iq)])
            ms.append((time.perf_counter() - t0) * 1e3)
        prof = None
        activities = [torch.profiler.ProfilerActivity.CUDA, torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=activities) as p:
            t0 = time.perf_counter()
            radio.process(iq[0])
            span = (time.perf_counter() - t0) * 1e3
        if rank == 0:
            ks = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            top = sorted(p.key_averages(), key=lambda e: -e.cpu_time_total)[:4]
            prof = (span, sum(e.time_range.elapsed_us() for e in ks) / 1e3, len(ks),
                    [(e.key, round(e.cpu_time_total / 1e3, 2)) for e in top])
        radio.close()
        out.append((transport, ms[1:], prof))
    return out


def sharded() -> None:
    sys.path.insert(0, os.path.abspath("."))
    from radioframe_torch.shard.mesh import spawn

    label = card()
    for i, res in enumerate(spawn(_sharded_rank, 4, "cuda:0", timeout_s=400.0)):
        for transport, ms, prof in res:
            line = f"[sharded] rank {i} {transport}: host ms per block " + ", ".join(
                f"{m:.1f}" for m in ms)
            if prof:
                line += (f"; profiled block {prof[0]:.1f} ms, device busy {prof[1]:.2f} ms in "
                         f"{prof[2]} activities, top host ops (ms) {prof[3]}")
            print(f"{line} ({label})", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the probe needs a CUDA card")
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("kernels", "variants", "sharded"))
    ap.add_argument("--tree", default=".")
    a = ap.parse_args()
    if a.what == "kernels":
        kernels(a.tree)
    elif a.what == "variants":
        variants()
    else:
        sharded()


if __name__ == "__main__":
    main()
