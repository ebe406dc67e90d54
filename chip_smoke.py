"""Drive the PyTorch port's flagship receive chain once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, each printing its results:

  1. device    card name, power limit, CUDA and nvcc versions
  2. build     compile the fused front-end kernel (K1) from the checkout
  3. kernel    K1 against its plain PyTorch version on the card at the
               flagship shapes (C=128, T=131072, R1=8, R2=4): f32 planes,
               int16 counts and a shared (1, T) wideband input, two blocks;
               then ragged last tiles in single-stage and 2x2 decimation
  4. slice     Radio on the flagship RxConfig (the configuration bench.py
               times) for 4 blocks through K1, against the same chain with
               the plain front end (the dense front end reported beside it)
  5. time      CUDA-event medians: RxChain.step, K1 alone, plain front end;
               host-clock median of Radio.process from a numpy block
               (before phase 6: the chain's step time depends on the host)
  6. audio     SSB/AM/NFM captures through the card's chain, SNR within 1 dB
               of the same chain on the CPU

Any failed check raises, and the script exits non-zero. The last two lines
are the kernel table and {"ok": true, "device": {...}} as JSON.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from radioframe.core.config import CicStage, FirStage, RxConfig
from radioframe.diag.metrics import audio_snr_db
from radioframe.io import fixtures as FX
from radioframe_torch.api.radio import Radio
from radioframe_torch.kernels import _build
from radioframe_torch.kernels.fused_frontend2 import FusedFrontend2, plain_step
from radioframe_torch.ops import nco
from radioframe_torch.ops.demod import NFM
from radioframe_torch.pipelines.rx_chain import RxChain

C_FLAG = 128
T_FLAG = 131072
FS_IN = 1_536_000.0
SEED = 0
FRONTEND_TOL = 5e-4  # the reference's on-chip front-end bound (VERIFY_TPU_r05 tol)
CHAIN_TOL = 2e-4     # chain audio after block 0 (the bound of tests/test_fused_frontend.py)
SNR_TOL_DB = 1.0     # BASELINE's audio bar
K1_SOURCE = "radioframe_torch/kernels/csrc/fused_frontend2.cu"
K1_REPLACES = "radioframe/kernels/fused_frontend2.py:49"


def flagship_config(channels: int | None = None, fused: bool = True) -> RxConfig:
    """bench.py main()'s flagship RX chain (128 channels unless given)."""
    return RxConfig(
        fs_in=FS_IN, channels=C_FLAG if channels is None else channels,
        stages=(CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
        ols_hop=512, fuse_frontend=fused, fuse_frontend_depth=2,
        enabled_modes=(0, 1, 2, 3))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, runs: int = 7, inner: int = 10, warmup: int = 3) -> float:
    """Median over ``runs`` of the CUDA-event time of ``inner`` calls, per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: chip_smoke needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvcc: {nvcc}")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build("fused_frontend2")
    print(f"[build] {built.path.name}: nvcc {built.seconds:.2f} s, "
          f"load {time.perf_counter() - t0:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def _kernel_cases(dev):
    """(label, front end, C, T, input form): the flagship's three input forms,
    then two other code paths of the kernel at small shapes — a ragged last
    tile in single-stage mode (R2 = 1), and a ragged last tile with
    decimation 2x2 (the default RxConfig's stage plan)."""
    flag = RxChain(flagship_config())._stage_taps
    small = RxChain(RxConfig(channels=5, fuse_frontend=True, fuse_frontend_depth=2))._stage_taps
    return [
        ("f32", FusedFrontend2(flag[0], 8, flag[1], 4).to(dev), C_FLAG, T_FLAG, "f32"),
        ("int16", FusedFrontend2(flag[0], 8, flag[1], 4, input_scale=2.0 ** -15).to(dev),
         C_FLAG, T_FLAG, "int16"),
        ("wideband", FusedFrontend2(flag[0], 8, flag[1], 4).to(dev), C_FLAG, T_FLAG,
         "wideband"),
        ("single-stage ragged", FusedFrontend2(flag[0], 8).to(dev), 5, 20000, "f32"),
        ("decim 2x2 ragged", FusedFrontend2(small[0], 2, small[1], 2).to(dev), 5, 20000, "f32"),
    ]


def _planes(rng, form: str, C: int, T: int, dev):
    if form == "int16":
        x = np.clip(np.round(rng.standard_normal((2, C, T)) * 8000.0), -32768, 32767)
        x = x.astype(np.int16)
    else:
        rows = 1 if form == "wideband" else C
        x = rng.standard_normal((2, rows, T)).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    return x[0], x[1]


def phase_kernel(dev, blocks: int = 2) -> float:
    """K1 against plain_step on the card; returns the largest |y| difference."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    for label, ff, C, T, form in _kernel_cases(dev):
        words_np = nco.freq_word(np.linspace(-5e5, 5e5, C), FS_IN)
        words_np[0] = 2 ** 31 - 7  # acc + word*T wraps every block
        words = torch.from_numpy(words_np).to(dev)
        st_k = ff.init_state(C)
        st_p = ff.init_state(C)
        acc_np = np.zeros(C, np.int64)
        for blk in range(blocks):
            xr, xi = _planes(rng, form, C, T, dev)
            before = ff.launches
            st_k, y_k, p_k = ff.step_planes(st_k, xr, xi, words, return_power=True)
            check(ff.launches == before + 1, f"{label}: launch counter")
            y_p, p_p = plain_step(ff, xr, xi, st_p["tail"], st_p["acc"], words)
            st_p = ff.next_state(st_p, xr, xi, words)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            p_rel = float(((p_k - p_p).abs() / p_p.abs()).max())
            worst = max(worst, err)
            acc_np = (acc_np + words_np.astype(np.int64) * T + 2 ** 31) % 2 ** 32 - 2 ** 31
            tail_ref = torch.complex(xr[:, T - ff.H_carry:].float(),
                                     xi[:, T - ff.H_carry:].float()).expand(C, -1)
            check(err <= FRONTEND_TOL, f"{label} block {blk}: max|y_k - y_plain| {err:.3g}")
            check(p_rel <= 1e-5, f"{label} block {blk}: power rel err {p_rel:.3g}")
            check(np.array_equal(st_k["acc"].cpu().numpy(), acc_np.astype(np.int32)),
                  f"{label} block {blk}: acc")
            check(torch.equal(st_k["tail"], tail_ref), f"{label} block {blk}: tail")
            print(f"[kernel] {label} block {blk}: y {tuple(y_k.shape)} max|err| {err:.3e} "
                  f"(scale {float(y_p.abs().max()):.3f}), power rel {p_rel:.2e}, "
                  f"acc and tail bit-equal")
    return worst


def _nfm_mod(d: np.ndarray, modes: np.ndarray, period: float) -> np.ndarray:
    """NFM rows compared modulo fs/deviation: an atan2 branch flip at ±pi
    moves one sample by exactly that."""
    d = d.copy()
    rows = modes == NFM
    d[rows] -= period * np.round(d[rows] / period)
    return d


@torch.no_grad()
def plain_front_step(chain: RxChain, state, iq, words, modes):
    """``chain.step`` with the fused front end computed by ``plain_step``."""
    fstate, bstate = chain.split_state(state)
    ff = chain.fused
    planes = torch.view_as_real(iq)
    xr, xi = planes[..., 0], planes[..., 1]
    fst = {"acc": fstate["nco"], "tail": fstate["decim"][0]}
    x, pw = plain_step(ff, xr, xi, fst["tail"], fst["acc"], words)
    fst = ff.next_state(fst, xr, xi, words)
    tails = [fst["tail"]]
    for d, tail in zip(chain.decimators[chain.fused_stages:], fstate["decim"][1:]):
        x, t = d(tail, x)
        tails.append(t)
    bstate, audio, aux = chain.step_back(bstate, x, modes, pw * chain.power_scale(iq.shape[-1]))
    return {"nco": fst["acc"], "decim": tuple(tails), **bstate}, audio, aux


def phase_slice(dev, blocks: int = 4) -> int:
    """The flagship Radio through K1, held against the same chain with the
    plain front end; the dense front end (NCO mix + conv decimators) is
    reported beside it. Returns the K1 launches of the Radio's run."""
    cfg = flagship_config()
    radio = Radio(cfg, device=dev)
    names = ("ssb", "cw", "am", "nfm")
    for ch, f in enumerate(np.linspace(-5e5, 5e5, C_FLAG)):
        radio.tune(ch, float(f))
        radio.set_mode(ch, names[ch % 4])
    twin = RxChain(cfg).to(dev)
    dense = RxChain(flagship_config(fused=False)).to(dev)
    st_p, st_d = twin.init_state(), dense.init_state()
    words = torch.from_numpy(nco.freq_word(radio._freqs, FS_IN)).to(dev)
    modes = torch.from_numpy(radio._modes).to(dev)
    rng = np.random.default_rng(SEED + 1)
    period = cfg.fs_audio / cfg.nfm_deviation_hz
    iq = [(rng.standard_normal((C_FLAG, T_FLAG), np.float32)
           + 1j * rng.standard_normal((C_FLAG, T_FLAG), np.float32)).astype(np.complex64)
          for _ in range(blocks)]
    radio.chain.fused.launches = 0
    audio = [radio.process(x) for x in iq]
    launches = radio.chain.fused.launches
    check(launches == blocks, f"K1 launched {launches} times for {blocks} blocks")
    for blk, (x, a) in enumerate(zip(iq, audio)):
        xd = torch.from_numpy(x).to(dev)
        st_p, a_p, _ = plain_front_step(twin, st_p, xd, words, modes)
        with torch.no_grad():
            st_d, a_d, _ = dense.step(st_d, xd, words, modes)
        check(a.shape == (C_FLAG, T_FLAG // cfg.decim) and bool(np.isfinite(a).all()),
              f"block {blk}: audio shape {a.shape} / finite")
        err = float(np.abs(_nfm_mod(a - a_p.cpu().numpy(), radio._modes, period)).max())
        d = np.abs(_nfm_mod(a - a_d.cpu().numpy(), radio._modes, period))
        per_mode = ", ".join(f"{n} {d[radio._modes == k].max():.2e}" for k, n in enumerate(names))
        if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
            check(err <= CHAIN_TOL, f"block {blk}: K1 chain vs plain-front-end chain {err:.3g}")
        print(f"[slice] block {blk}: audio {a.shape} finite; max|K1 chain - plain-front-end "
              f"chain| {err:.3e}{' (cold start, not held)' if blk == 0 else ''}; "
              f"max|K1 chain - dense chain| by mode: {per_mode}")
    print(f"[slice] K1 launches in the main path: {launches}")
    return launches


def _captures(n: int):
    ssb, ssb_truth = FX.ssb_capture(FS_IN, n, 100_000.0)
    am, am_truth = FX.am_capture(FS_IN, n, -200_000.0)
    nfm, nfm_truth = FX.nfm_capture(FS_IN, n, 300_000.0)
    wide = (ssb + am + nfm).astype(np.complex64)
    return wide, [("ssb", 100_000.0, ssb_truth), ("am", -200_000.0, am_truth),
                  ("nfm", 300_000.0, nfm_truth)]


def _score(device, wide, rows, blocks: int) -> list[float]:
    radio = Radio(flagship_config(channels=len(rows)), device=device)
    for ch, (mode, f, _) in enumerate(rows):
        radio.tune(ch, f)
        radio.set_mode(ch, mode)
    audio = np.concatenate([radio.process(b) for b in np.split(wide, blocks)], axis=-1)
    settle = 32 * 1024  # the AM dc-blocker turn-on transient pumps the AGC
    snrs = []
    for ch, (mode, _, truth) in enumerate(rows):
        if mode == "ssb":
            snrs.append(audio_snr_db(truth, audio[ch]))
        else:
            snrs.append(audio_snr_db(truth[settle:], audio[ch][settle:], trim=1024))
    return snrs


def phase_audio(dev, blocks: int = 16) -> None:
    wide, rows = _captures(blocks * T_FLAG)
    card = _score(dev, wide, rows, blocks)
    cpu = _score("cpu", wide, rows, blocks)
    for (mode, f, _), s_card, s_cpu in zip(rows, card, cpu):
        print(f"[audio] {mode.upper():3s} @ {f / 1e3:+.0f} kHz: SNR card {s_card:.2f} dB, "
              f"cpu {s_cpu:.2f} dB, delta {s_card - s_cpu:+.3f} dB")
        check(abs(s_card - s_cpu) <= SNR_TOL_DB, f"{mode} SNR card vs cpu")
        check(s_card > 20.0, f"{mode} SNR {s_card:.1f} dB")


def phase_time(dev, label: str) -> tuple[float, float]:
    """ms per block for RxChain.step, K1 alone and the plain front end (CUDA
    events), and for Radio.process from a numpy block (host clock: the
    host-to-device copy of the block is part of what a user waits for)."""
    cfg = flagship_config()
    chain = RxChain(cfg).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    iq = torch.complex(torch.randn((C_FLAG, T_FLAG), generator=g, device=dev),
                       torch.randn((C_FLAG, T_FLAG), generator=g, device=dev))
    words = torch.from_numpy(nco.freq_word(np.linspace(-5e5, 5e5, C_FLAG), FS_IN)).to(dev)
    modes = torch.arange(C_FLAG, device=dev, dtype=torch.int32) % 4
    state = [chain.init_state()]

    def chain_step():
        state[0], _, _ = chain.step(state[0], iq, words, modes)

    ff = chain.fused
    fst = ff.init_state(C_FLAG)
    planes = torch.view_as_real(iq)
    xr, xi = planes[..., 0], planes[..., 1]

    with torch.no_grad():
        ms_chain = median_ms(chain_step)
        ms_k1 = median_ms(lambda: ff.step_planes(fst, xr, xi, words, return_power=True))
        ms_plain = median_ms(lambda: plain_step(ff, xr, xi, fst["tail"], fst["acc"], words))
    radio = Radio(cfg, device=dev)
    for ch, f in enumerate(np.linspace(-5e5, 5e5, C_FLAG)):
        radio.tune(ch, float(f))
        radio.set_mode(ch, ("ssb", "cw", "am", "nfm")[ch % 4])
    block = iq.cpu().numpy()
    runs = []
    for i in range(8):
        t0 = time.perf_counter()
        radio.process(block)  # returns numpy: ends after the device-to-host copy
        if i >= 3:
            runs.append((time.perf_counter() - t0) * 1e3)
    ms_radio = statistics.median(runs)
    n = C_FLAG * T_FLAG
    for what, ms in (("RxChain.step", ms_chain), ("K1 fused_frontend2", ms_k1),
                     ("plain front end", ms_plain), ("Radio.process (host clock)", ms_radio)):
        print(f"[time] {what}: {ms:.4f} ms/block, {n / (ms * 1e-3):.4g} IQ samples/s "
              f"({label})")
    return ms_k1, ms_plain


def main() -> None:
    dev = torch.device("cuda")
    name, smi = phase_device()
    phase_build()
    worst = phase_kernel(dev)
    launches = phase_slice(dev)
    ms_k1, ms_plain = phase_time(dev, smi)
    phase_audio(dev)
    print(f"[card] {smi}")
    print(json.dumps({"kernels": [{
        "name": "fused_frontend2", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": ms_k1, "plain_ms": ms_plain}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
