"""Where the flagship slice's kernels and steps spend their time on one
NVIDIA GPU.

    python3 probe_frontend.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. At the flagship's shapes (C=128, T=131072; K2 at
R=8, J0=4; K6 at Ta=4096, nfft=1024, hop=512) it prints, all in one process
so that the numbers compare:

  1. variants   K2's five cost variants (kernel K8: full, no_osc, no_tr,
                osc_only, copy_only), device time from torch.profiler, each
                beside full and with its plan; full's output against K2's
                own launch (bit-equal)
  1b. k2        K2 on the chain's interleaved complex view: its plan's knobs
                swept (strips per channel 1, 2, 3, 4, 6; ring stages 2, 3,
                4; chunks of 1024, 2048, 4096 samples), CUDA-event and
                device time each, y against plain_fused_frontend
  2. k6-phases  K6 built from edited copies of csrc/ with one of its three
                phases removed (FFT, demod values, walk with all its passes):
                their outputs are wrong, their times are the other phases';
                then the S sweep of K6's segmented walk (walk_segments, the
                argument of walk_plan.plan), CUDA-event and device time per S
  3. k1         K1 (fused_frontend2) on the chain's interleaved complex
                view at C=128, T=131072: its plan's knobs swept (strips per
                channel 1, 2, 3, 4, 6; ring stages 2, 3, 4; chunks of 1024,
                2048, 4096 samples), then variants built from edited copies
                of csrc/ (the oscillator by the fast __sincosf, with its
                largest error against plain_step beside the shipped
                sincosf's; no oscillator, no stage 1, no stage 2, no mix:
                their outputs are wrong, their times bound each part's
                cost); int16 counts.
                CUDA-event and device time each
  4. profile    torch.profiler over 5 RxChain.step calls of the slice
                configuration (K2 front end, K6 back end) and of the K1
                chain: device kernels by time, device busy share of the span

Every time is printed beside nvidia-smi's card name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (C_FLAG, FS_IN, T_FLAG, _carry0, device_ms, flagship_config,
                        slice_config)
from probe_channelizer import build_edited, build_variant, median_ms, profile_steps, segment_sweep
from radioframe_torch.kernels import frontend_plan
from radioframe_torch.kernels import fused_frontend as K2
from radioframe_torch.kernels import fused_frontend2 as K1
from radioframe_torch.kernels import ols_demod as K6
from radioframe_torch.kernels.fused_frontend import VARIANTS
from radioframe_torch.ops import nco
from radioframe_torch.ops.demod import filter_index
from radioframe_torch.pipelines.rx_chain import RxChain

K6_PHASES = {  # name -> [(file, old text, new text)], applied to a copy of csrc/
    "shipped": [],
    "no FFT phase": [("ols_demod.cu", "base < items;", "base < 0;")],
    "no demod phase": [("ols_demod.cu", "i < n;\n", "i < 0;\n")],
    "no walk": [("ols_demod.cu", "  else\n    rf::agc_walk_all(a, a.barrier + 2);\n}", "}")],
}
K1_VARIANTS = {  # name -> [(file, old text, new text)], applied to a copy of csrc/
    "shipped": [],
    "__sincosf": [("frontend.cuh", "  sincosf(ang, &s, &co);", "  __sincosf(ang, &s, &co);")],
    "no oscillator": [("frontend.cuh", "  sincosf(ang, &s, &co);",
                       "  s = 0.f * ang;\n  co = 1.f;")],
    "no stage 1": [("fused_frontend2.cu", "    stage1(n1, J2 + filled * a.q2);\n", "")],
    "no stage 2": [("fused_frontend2.cu", "q < count; q += kThreads", "q < 0; q += kThreads")],
    "no mix (loads and power only)": [
        ("frontend.cuh", "mix(theta0 + word * static_cast<uint32_t>(e), e, J0, v.x, v.y);",
         "(void)v;"),
        ("frontend.cuh", "mix(theta0 + word * static_cast<uint32_t>(e), e, J0, re, im);",
         "(void)re;")],
}


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the probe needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    chain = RxChain(slice_config()).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    iq = torch.complex(torch.randn((C_FLAG, T_FLAG), generator=g, device=dev),
                       torch.randn((C_FLAG, T_FLAG), generator=g, device=dev))
    words = torch.from_numpy(nco.freq_word(np.linspace(-5e5, 5e5, C_FLAG), FS_IN)).to(dev)
    modes = torch.arange(C_FLAG, device=dev, dtype=torch.int32) % 4
    ff, k6 = chain.fused, chain.backend_kernel
    fst = ff.init_state(C_FLAG)
    planes = torch.view_as_real(iq)
    xr, xi = planes[..., 0], planes[..., 1]

    kern = (xr, xi, fst["tail"], fst["acc"], words)
    y_k2, _ = ff._launch(*kern)
    full = None
    for v in VARIANTS:
        t = device_ms(lambda v=v: ff._launch(*kern, v))
        full = t if v == "full" else full
        note = ""
        if v == "full":
            same = torch.equal(ff._launch(*kern, v)[0], y_k2)
            note = f", output {'bit-equal to' if same else 'differs from'} K2's"
        print(f"[variant] K8 {v}: {t:.4f} ms device time per block ({t / full:.2f}x full)"
              f"{note}; plan {frontend_plan.describe(ff.last_plan)} ({card})")
    y_plain, _ = K2.plain_fused_frontend(ff, *kern)
    plan_sweeps("k2", ff, lambda: ff._launch(*kern), y_plain, card)

    with torch.no_grad():
        fstate, bstate = chain.split_state(chain.init_state())
        _, x, _ = chain.step_front(fstate, iq, words)
    h_sel = chain.mode_bank._H.index_select(0, filter_index(modes).long())
    cw_word = torch.full((C_FLAG,), chain.cw_tone_word, dtype=torch.int32, device=dev)
    args = (bstate["bpf"], x, h_sel, modes, cw_word, torch.zeros_like(cw_word),
            *chain.agc_bank.per_channel(modes), _carry0(C_FLAG, dev))
    shipped = K6._kernel_fn
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits) in enumerate(K6_PHASES.items()):
            fn = build_variant(Path(tmp) / str(i), edits,
                               ((K6, "ols_demod", "rf_ols_demod"),))["ols_demod"]
            K6._kernel_fn = lambda f=fn: f
            print(f"[k6-phases] {name}: {device_ms(lambda: k6(*args)):.4f} ms device time "
                  f"per block ({card})")
    K6._kernel_fn = shipped
    with torch.no_grad():
        segment_sweep(k6, lambda: k6(*args), (1, 2, 4, 8, 16, 32, 64, 128, 256),
                      f"K6 C={C_FLAG} Ta={x.shape[-1]}", card)

    k1_sweeps(dev, iq, words, card)

    for label, cfg in (("slice steps (K2 + K6)", slice_config()),
                       ("K1 chain steps", flagship_config())):
        c = RxChain(cfg).to(dev)
        st = [c.init_state()]

        def step(c=c, st=st):
            st[0], _, _ = c.step(st[0], iq, words, modes)
        profile_steps(step, label, card, top=8)


def _timed(tag: str, ff, run, y_plain, label: str, card: str) -> None:
    """One line: the launch's plan, its CUDA-event and device time, y against
    the plain version."""
    y, _ = run()
    err = float((y - y_plain).abs().max())
    print(f"[{tag}] {label}: {frontend_plan.describe(ff.last_plan)}; CUDA events "
          f"{median_ms(run):.4f} ms, device {device_ms(run):.4f} ms; max|y - plain| "
          f"{err:.2e} ({card})", flush=True)


def plan_sweeps(tag: str, ff, run, y_plain, card: str) -> None:
    """A fused front end's plan knobs (K1's or K2's: strips per channel,
    ring stages, chunk), one at a time from the plan's defaults."""
    stages_default = ff.stages
    with torch.no_grad():
        for strips in (1, 2, 3, 4, 6):
            ff.strips = strips
            _timed(tag, ff, run, y_plain, f"strips {strips} a channel", card)
        ff.strips = None
        for stages in (2, 3, 4):
            ff.stages = stages
            _timed(tag, ff, run, y_plain, f"stages {stages}", card)
        ff.stages = stages_default
        for chunk in (1024, 2048, 4096):
            ff.chunk = chunk
            _timed(tag, ff, run, y_plain, f"chunk {chunk}", card)
        ff.chunk = None


def k1_sweeps(dev, iq, words, card: str) -> None:
    """K1's plan knobs and source variants on the flagship's interleaved
    complex view (section 3 of the module docstring)."""
    ff = RxChain(flagship_config()).to(dev).fused
    fst = ff.init_state(C_FLAG)
    planes = torch.view_as_real(iq)
    xr, xi = planes[..., 0], planes[..., 1]
    run = lambda: ff._launch(xr, xi, fst["tail"], fst["acc"], words)  # noqa: E731
    y_plain, _ = K1.plain_step(ff, xr, xi, fst["tail"], fst["acc"], words)
    plan_sweeps("k1", ff, run, y_plain, card)
    with torch.no_grad():
        shipped = K1._kernel_fns
        with tempfile.TemporaryDirectory() as tmp:
            for i, (name, edits) in enumerate(K1_VARIANTS.items()):
                lib = build_edited(Path(tmp) / str(i), edits,
                                   ["fused_frontend2"])["fused_frontend2"]
                fns = {}
                for dtype, sym in ((torch.float32, "rf_fused_frontend2_f32"),
                                   (torch.int16, "rf_fused_frontend2_i16")):
                    fn = getattr(lib, sym)
                    fn.argtypes, fn.restype = shipped()[dtype].argtypes, ctypes.c_int
                    fns[dtype] = fn
                K1._kernel_fns = lambda f=fns: f
                _timed("k1", ff, run, y_plain, f"variant {name}", card)
        K1._kernel_fns = shipped
        ff16 = K1.FusedFrontend2(*RxChain(flagship_config())._stage_taps[:1], ff.R,
                                 RxChain(flagship_config())._stage_taps[1], ff.R2,
                                 input_scale=2.0 ** -15).to(dev)
        g = torch.Generator(device=dev).manual_seed(1)
        x16 = torch.randint(-8000, 8000, (2, C_FLAG, T_FLAG), generator=g, device=dev,
                            dtype=torch.int16)
        run16 = lambda: ff16._launch(x16[0], x16[1], fst["tail"], fst["acc"], words)  # noqa: E731
        run16()
        print(f"[k1] int16: {frontend_plan.describe(ff16.last_plan)}; CUDA events "
              f"{median_ms(run16):.4f} ms, device {device_ms(run16):.4f} ms ({card})", flush=True)


if __name__ == "__main__":
    main()
