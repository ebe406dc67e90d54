"""Where the config-5 channelizer's time goes on one NVIDIA GPU.

    python3 probe_channelizer.py            # phases 1-3 below
    python3 probe_channelizer.py sharded    # phase 4 alone

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. At config 5's shapes (M=4096, K=8, T=8388608) it
prints, all in one process so that the numbers compare:

  1. variants   K4 (demod_agc) and K5 (channelizer_one) built from edited
                copies of csrc/ and timed with CUDA events: the shipped
                sources; the walk's per-frame waterfall index by integer
                div/mod (the first form); the walk's load batch U at 16 and
                32; phase one or the walk (all its passes) removed (their
                outputs are wrong, their times are the other phase's); K4
                with __launch_bounds__(256, 4) and (256, 2) against the
                shipped (256, 3), and with two frames a thread in phase one;
                K5's frames per block at 2, 4, 8 and 16. Each variant's
                outputs are compared with the shipped sources'.
     walk       the S sweep of the segmented walk (walk_segments, the
                argument of walk_plan.plan): K4 at M=4096, F=2048 (1, 8, 16,
                22, 32, 64, 128) and at the sharded form's M/D=1024, K5 at
                F=2048 and its emit_env variant at the sharded path's
                F_local=512, CUDA-event and device time per S, and the
                audio's largest difference from S = 1's; the emit_env
                variant's time at F_local with phase one's frames per block
                at 2, 4, 8 and the shipped 1 (its grid).
  2. k9         K3's stage variants (kernel K9, the template argument of
                csrc/pfb_dft.cu): each variant's CUDA-event time, and its
                device time under torch.profiler.
  3. profile    torch.profiler over 5 single-pass ChannelizerChain.step
                calls: device kernels by time, device busy share of the span.
  4. sharded    four ranks on the one card (gloo), Monitor(mesh=...) on a
                (1, 4) mesh in chip_smoke.py's three forms (xla, emit_env,
                two-kernel), 5 blocks each: the host time of each block split
                into the rank's slice of the numpy block, its copy to the
                card, ShardedChannelizer.step, the gather of audio and aux,
                and the copy of the global audio back, each ended by a
                synchronize; on rank 0, device busy time of one profiled step.

Every time is printed beside nvidia-smi's card name and power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import shutil
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from chip_smoke import device_ms, profile_steps
from radioframe_torch.core import presets
from radioframe_torch.kernels import _build
from radioframe_torch.kernels import channelizer_one as K5
from radioframe_torch.kernels import demod_agc as K4
from radioframe_torch.kernels.pfb_dft import VARIANTS as K9_VARIANTS
from radioframe_torch.pipelines.channelizer import ChannelizerChain

M, T = 4096, 128 * 65536
# the walk's call in each kernel, removed by the "no walk" variant
WALK = {"demod_agc.cu": "rf::agc_walk_all(a, a.barrier + 1);\n}",
        "channelizer_one.cu": ("rf::agc_walk_all<kChannelMajor>(a, a.barrier + 1, "
                               "reinterpret_cast<float*>(smem));\n}")}
VARIANTS = {  # name -> [(file, old text, new text)], applied to a copy of csrc/
    "shipped": [],
    "div/mod waterfall index": [("channelizer.cuh", "if (++nacc == a.wf_avg) {",
                                 "if ((f + 1) % a.wf_avg == 0) {"),
                                ("channelizer.cuh", "a.wf[line * M + c]",
                                 "a.wf[static_cast<long long>(f / a.wf_avg) * M + c]")],
    "walk batch U=16": [("channelizer.cuh", "constexpr int U = 8;", "constexpr int U = 16;")],
    "walk batch U=32": [("channelizer.cuh", "constexpr int U = 8;", "constexpr int U = 32;")],
    "no walk": [(f, call, "}") for f, call in WALK.items()],
    "no phase one": [("demod_agc.cu", "i < n;\n", "i < 0;\n"),
                     ("channelizer_one.cu", "i <= chunk;", "i < 0;")],
    "K4 launch bounds (256, 4)": [("demod_agc.cu", "constexpr int kMinBlocks = 3;",
                                   "constexpr int kMinBlocks = 4;")],
    "K4 launch bounds (256, 2)": [("demod_agc.cu", "constexpr int kMinBlocks = 3;",
                                   "constexpr int kMinBlocks = 2;")],
    "K4 two frames a thread": [("demod_agc.cu", "constexpr int kFrames = 1;",
                                "constexpr int kFrames = 2;")],
}


def median_ms(fn, runs: int = 7, inner: int = 10) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def build_edited(root: Path, edits, names) -> dict:
    """Compile csrc/<name>.cu for each of ``names`` from a copy of csrc/ with
    ``edits`` ((file, old text, new text)) applied; returns {name: CDLL}.
    Each variant's ptxas line (registers, spills) is printed."""
    src = root / "csrc"
    shutil.copytree(_build.CSRC, src)
    for fname, old, new in edits:
        f = src / fname
        text = f.read_text()
        if old not in text:
            raise RuntimeError(f"variant edit not found in {fname}: {old!r}")
        f.write_text(text.replace(old, new))
    libs = {}
    for name in names:
        out = root / f"{name}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
                               str(src / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(proc.stdout + proc.stderr)
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {root.name} {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def build_variant(root: Path, edits, kernels=((K4, "demod_agc", "rf_demod_agc"),
                                               (K5, "channelizer_one", "rf_channelizer_one"))) -> dict:
    """Compile ``kernels`` ((wrapper module, source name, C symbol); K4 and
    K5 by default) from an edited copy of csrc/; returns the C entry points."""
    libs = build_edited(root, edits, [name for _, name, _ in kernels])
    fns = {}
    for mod, name, sym in kernels:
        fn = getattr(libs[name], sym)
        fn.argtypes, fn.restype = mod._kernel_fn().argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the probe needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cfg = presets.channelizer_61m44(M)
    one = ChannelizerChain(cfg).to(dev)
    two = ChannelizerChain(dataclasses.replace(cfg, fuse_single_pass=False)).to(dev)
    k3, k4, k5 = two.pfb, two.demod_kernel, one.one_kernel
    g = torch.Generator(device=dev).manual_seed(0)
    wr, wi = torch.randn(T, generator=g, device=dev), torch.randn(T, generator=g, device=dev)
    mode = torch.arange(M, device=dev, dtype=torch.int32) % 4
    tail = k3.init_state(1)
    (yr, yi), _ = k3.step_planes(tail, wr, wi)
    rel, al, tgt, mg = one.agc_bank.per_channel(mode)
    word = torch.full((M,), one.cw_tone_word, dtype=torch.int32, device=dev)
    consts = (mode, word, torch.zeros_like(word), rel, al, tgt, mg)
    st0 = torch.zeros((7, M), device=dev)
    st0[2] = 1.0
    run4 = lambda: k4(yr, yi, *consts, st0)
    run5 = lambda: k5.call_planes(tail, wr, wi, *consts, st0)
    print(f"[probe] {card}; K3 alone {median_ms(lambda: k3.step_planes(tail, wr, wi)):.4f} ms")
    shipped = (K4._kernel_fn(), K5._kernel_fn())
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits) in enumerate(VARIANTS.items()):
            fns = build_variant(Path(tmp) / str(i), edits)
            K4._kernel_fn = lambda f=fns["demod_agc"]: f
            K5._kernel_fn = lambda f=fns["channelizer_one"]: f
            out = run4() + run5()
            ref = out if ref is None else ref
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            print(f"[variant] {name}: K4 {median_ms(run4):.4f} ms, K5 {median_ms(run5):.4f} ms, "
                  f"outputs {'equal to' if same else 'differ from'} the shipped ({card})")
        K4._kernel_fn, K5._kernel_fn = (lambda: shipped[0]), (lambda: shipped[1])
        for fpb in (2, 4, 8, 16, K5.FRAMES_PER_BLOCK):
            K5.FRAMES_PER_BLOCK = fpb
            print(f"[variant] K5 frames per block {fpb}: {median_ms(run5):.4f} ms ({card})")
    walk_sweep(k4, yr, yi, k5, tail, wr, wi, consts, st0, card)

    for v in K9_VARIANTS:
        run = lambda v=v: k3._launch(tail, wr, wi, v)  # noqa: E731
        print(f"[k9] {v}: {median_ms(run):.4f} ms (CUDA events, {card})")
        profile_steps(run, f"K9 {v} launches", card, top=1)

    wb = torch.complex(wr, wi)
    st = [one.init_state()]

    def step():
        st[0], _, _ = one.step(st[0], wb, mode)
    profile_steps(step, "single-pass steps", card)


def segment_sweep(kernel, run, segments, label: str, card: str) -> None:
    """Time ``run`` (a launch of ``kernel``, K5 or K6) at each S of
    ``segments`` set through ``kernel.walk_segments``; print each S with its L,
    CUDA-event and device time, and the largest audio difference from S = 1's
    run (NFM rows included: an atan2 branch flip shows as its period)."""
    ref = None
    for S in segments:
        kernel.walk_segments = S
        audio = run()[0]
        ref = audio if ref is None else ref
        plan = kernel.last_plan
        print(f"[walk] {label} S={plan.segments} L={plan.length}: CUDA events "
              f"{median_ms(run):.4f} ms, device {device_ms(run):.4f} ms; max|audio - "
              f"S=1's| {float((audio - ref).abs().max()):.2e} ({card})", flush=True)
    kernel.walk_segments = None


def walk_sweep(k4, yr, yi, k5, tail, wr, wi, consts, st0, card: str) -> None:
    """The S sweep of K4's walk at M=4096 and M/D=1024 (F=2048), of K5's at
    F=2048, and of K5's emit_env variant (AM off) at the sharded path's
    F_local=512."""
    with torch.no_grad():
        segment_sweep(k4, lambda: k4(yr, yi, *consts, st0), (1, 8, 16, 22, 32, 64, 128),
                      f"K4 M={M} F={T // M}", card)
        Ml = M // 4
        k4l = K4.FusedDemodAgc(Ml, k4.fs, k4.nfm_deviation_hz, wf_avg=k4.wf_avg,
                               enabled=tuple(sorted(k4.en))).to(yr.device)
        yl, il = yr[:, :Ml].contiguous(), yi[:, :Ml].contiguous()
        cl = tuple(t[:Ml] for t in consts)
        segment_sweep(k4l, lambda: k4l(yl, il, *cl, st0[:, :Ml].contiguous()),
                      (1, 16, 32, 64, 128), f"K4 M={Ml} F={T // M}", card)
        segment_sweep(k5, lambda: k5.call_planes(tail, wr, wi, *consts, st0),
                      (1, 2, 4, 8, 16, 32, 64, 128), f"K5 M={M} F={T // M}", card)
        k5e = K5.FusedChannelizerOne(M, k5.K, k5.fs, k5.nfm_deviation_hz, wf_avg=k5.wf_avg,
                                     enabled=(0, 1, 3, 4), apply_agc=False,
                                     emit_env=True).to(wr.device)
        n = T // 4
        run = lambda: k5e.call_planes(tail, wr[:n], wi[:n], *consts, st0)  # noqa: E731
        segment_sweep(k5e, run, (1, 2, 4, 8, 16, 32), f"K5 emit_env M={M} F={n // M}", card)
        shipped = K5.FRAMES_PER_BLOCK
        for fpb in (2, 4, 8, shipped):  # phase one's grid at F_local: F / fpb blocks
            K5.FRAMES_PER_BLOCK = fpb
            run()
            plan = k5e.last_plan
            print(f"[walk] K5 emit_env F={n // M} frames per block {fpb} (S={plan.segments} "
                  f"L={plan.length}): CUDA events {median_ms(run):.4f} ms ({card})", flush=True)
        K5.FRAMES_PER_BLOCK = shipped


def _sharded_rank(rank: int, world: int, device: str) -> dict:
    """One rank of ``sharded``: {form: [per-block {part: host ms}], busy}."""
    import time

    import chip_smoke as CS
    from radioframe_torch.shard.mesh import make_mesh

    dev = torch.device(device)
    mesh = make_mesh(1, world, device=dev)
    wide = CS._sc_inputs()
    out = {}
    for form, (change, modes) in CS.SC_FORMS.items():
        cfg = dataclasses.replace(presets.channelizer_61m44(CS.CH_M), **change)
        mon = CS._sc_monitor(cfg, modes, dev, mesh)
        mon.process(wide[0])  # warm-up: allocations and first launches
        parts = []

        def timed(fn, rec, key):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            rec[key] = (time.perf_counter() - t0) * 1e3
            return r

        with torch.no_grad():
            for b in range(5):
                rec = {}
                x = wide[b % len(wide)]
                local = timed(lambda: mon._shard_slice(x), rec, "slice")
                xd = timed(lambda: torch.from_numpy(local).to(dev), rec, "copy in")
                a, aux = timed(lambda: mon._shard_step(xd), rec, "step")
                a = timed(lambda: mon._shard_gather(a, aux), rec, "gather")
                timed(lambda: a.cpu().numpy(), rec, "copy out")
                parts.append(rec)
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                mon._shard_step(xd)
                torch.cuda.synchronize()
                span = (time.perf_counter() - t0) * 1e3
        trace = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        out[form] = (parts, sum(e.time_range.elapsed_us() for e in trace) / 1e3, span,
                     len(trace))
    return out


def sharded() -> None:
    from radioframe_torch.shard.mesh import spawn

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the probe needs a CUDA card")

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    ranks = spawn(_sharded_rank, 4, "cuda:0", timeout_s=600.0)
    for i, res in enumerate(ranks):
        for form, (parts, busy, span, acts) in res.items():
            med = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
            total = sum(med.values())
            line = ", ".join(f"{k} {v:.1f}" for k, v in med.items())
            print(f"[sharded] rank {i} {form}: host ms per block (median of {len(parts)}) "
                  f"{line}; sum {total:.1f}; one profiled step: device busy {busy:.2f} ms "
                  f"in {acts} activities over {span:.1f} ms ({card})", flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["sharded"]:
        sharded()
    else:
        main()
