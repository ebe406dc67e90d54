"""Drive the PyTorch port's receive chains, transmit chain, full duplex,
wideband channelizer, runtime (streaming, checkpoints) and API layer
(Transceiver, CAT over TCP, the CLI), the pipelined RX executor and the
digital modes once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card, nvcc and
PyTorch built for CUDA (no JAX needed). Phases, each printing its results:

  1. device     card name, power limit, CUDA and nvcc versions, and whether
                the card waits on 64-bit values from a stream (K7 needs it)
  2. build      compile the seven kernel sources from the checkout, one nvcc
                each, all started together (K1 fused_frontend2, K2 and K8
                fused_frontend, K3 and K9 pfb_dft, K4 demod_agc, K5
                channelizer_one, K6 ols_demod, K7 halo_dma); ptxas registers,
                spills and shared memory
  3. kernel     K1 against its plain PyTorch version on the card at the
                flagship shapes (C=128, T=131072, R1=8, R2=4), two blocks
                each: f32 planes, the interleaved complex view the chain
                passes, int16 counts and a shared (1, T) wideband input (the
                TMA bulk copy path), int16 rows of T+3 samples and f32
                planes viewed one column in (the per-thread cp.async path);
                then ragged last chunks in single-stage and 2x2 decimation,
                and adc_61m44's (R1, R2) = (32, 8) at C=128, T=655360 (K1's
                run-time instantiation); each case's plan
                (kernels/frontend_plan.py: strips, chunks, stages, copy path)
                printed
  3b. k2-kernel K2 against its plain version, two blocks each: the flagship
                shapes (R=8, J0=4) with f32 planes, the interleaved complex
                view and a shared (1, T) input (TMA bulk copies), f32 planes
                one column in (per-thread cp.async), R=32 (adc_61m44's CIC)
                at C=5, a ragged last chunk; each launch's plan printed, the
                power sum within rtol 1e-6, acc and tail bit-equal. Then K8's
                five variants against their plain versions at K8's shapes,
                each plan printed, full bit-equal to K2
  3c. k6-kernel K6 against its plain version, two blocks each, at C=128,
                Ta=4096, nfft=1024, hop=512 with instant and nonzero attack,
                and at C=5; each launch's walk plan (S segments of L
                samples, kernels/walk_plan.py) printed
  4. slice      Radio on the flagship RxConfig (the configuration bench.py
                times) for 4 blocks through K1, against the same chain with
                the plain front end (the dense front end reported beside it)
  4b. rx-slice  Radio on the slice configuration (the flagship with the
                depth-1 front end K2 and the fused back end K6) for 4 blocks,
                against the same chain built from the plain versions (audio,
                and power_in within rtol 1e-6); the K1 chain and the dense
                chain reported beside it
  5. ch-kernels K3, K4 and K5 against their plain versions at config 5's
                shapes (M=4096, K=8, T=8388608), two blocks each, with
                instant-attack, nonzero-attack and demod-only (apply_agc
                off) AGC, and small cases at M=64 and M=32 (below one full
                radix-16 pass of the FFT after its first); K4's and K5's
                walk plans (S segments of L frames) printed with each launch;
                K3's and K5's registers, shared memory, resident blocks and
                clusters (kernels/pfb_plan.py occupancy)
  5a. emit-env  K5's emit_env variant (demod only, AM off) against its plain
                version at M=4096, T=8388608, two blocks chaining carry row
                4 from zero: env and audio within 2e-4 of scale, the carry
                within 2e-4
  5b. shard-shapes  each kernel of the sharded channelizer (phase 6d) against
                its plain version at the shapes that path gives it on a (1, 4)
                mesh: K3 at F=1 (the single-pass forms' frame -1) and at
                F_local=512; K4 at M/D=1024 channels, F=2048 (the two-kernel
                form after the all_to_all); K5 demod-only ("xla" tier, all
                five modes) and its emit_env variant at F_local=512
  5c. walk-joins  the segmented walk at its joins, against the plain
                versions with nonzero attack over two blocks: K5 at M=4096,
                F=2048 with S=3 (a ragged last segment), at F=16 (one
                segment), at M=64, F=128 with S=8 (one waterfall line a
                segment); K6 at C=128, Ta=4096 with S=3 (ragged) and S=256;
                K4 at M=4096, F=2048 with S=3 (ragged) and at the sharded
                form's M/D=1024 with its plan's S, each with the AGC applied
                and demod only
  5c'. channel-major  K5's channel-major audio (the single-pass chain's)
                bit-equal to its frame-major audio transposed: M=4096,
                F=2048 at the plan's S in the three AGC cases, at S=3 (L=688,
                part-filled tiles) and S=1, at M=64 and M=16 (direct stores);
                the single-pass chain, with the AGC and on the hang route,
                bit-equal to K5 frame-major plus the transposed copy
  5d. k9        K9's five variants of K3 against their plain versions at
                M=4096, K=8, F=2048 (base_b3 bit-equal to K3, dft_only and
                batched_b3 within 2e-4 and pfb_* within 1e-5 of scale), and
                each variant's time, plain time and bound (batched_b3's also
                against the tensor cores' TF32 peak / 3); the registers and
                residency of base_b3, pfb_only, pfb_noshift and batched_b3,
                the input bytes K3's and pfb_only's column walks read, and
                the HMMA instructions in batched_b3's SASS (cuobjdump); the
                FFT alone (dft_only) against torch.fft.fft over the same
                planes, at M=4096 and at K6's nfft=1024 over (C·frames, 1024), timed
                beside it (torch.fft.fft is a yardstick; the port never
                calls it on the card path)
  6. ch-slice   Monitor on presets.channelizer_61m44(4096) for 4 blocks
                through K5, against the same chain built from the plain
                versions; the two-kernel Monitor (K3 -> K4) and the dense
                chain reported beside it
  6a. tx        TxChain at bench.py's tx_adc_r1280 (presets.tx_adc_61m44,
                C=64, Ta=512 -> 655,360 IQ samples a channel, 335.5 MB a
                block; words linspace(-20e6, 20e6), modes arange(64) % 5) and
                with a mic EQ at C=8, 3 blocks each; the first channel of each
                mode run again on the CPU: IQ within 5e-4, the FM phase within
                2e-3 as phasors, the NCO bit-equal
  6b. duplex    DuplexChain at bench.py's duplex row (C=128, T=131072; RX the
                flagship through K1, TX FIR(4) + CIC(8, 4), Ta=4096, modes
                arange(128) % 5) for 4 blocks, K1 counted; one channel of
                each mode on the CPU: RX audio within 2e-4 after block 0, TX
                IQ within 5e-4
  6c. rx-options  RxChain on the flagship with the dense back end and NB, NR,
                notch and VAD, and with NFM de-emphasis (531 us) and squelch,
                C=128, T=131072, 4 blocks, FM carriers in the NFM channels,
                K1 counted; one channel of each mode on the CPU: audio within
                2e-4 after block 0, VAD flags equal
  6d. sharded   four spawned ranks on the one card (gloo, file rendezvous),
                in one spawn with a timeout:
                halo-kernel: K7 against its plain version (the ppermute
                transport), bit-equal, at tests/test_halo_dma.py's D=4 cases
                and the full-width halo C=128, H=32, then a run of 60
                exchanges with no host wait between them (slots and acks
                reused past parity), each held bit-equal; the mismatch words
                read, required 0; put+recv time per rank beside the
                ppermute transport's.
                sharded-slice: Radio(mesh=...) on the slice configuration
                with halo_transport="rdma" (K2 + K7 + the composed back end)
                for 4 blocks on meshes (1, 4) at C=128, T=131072 and (2, 2)
                at config 3's C=64, against the unsharded port chain on the
                card and the same sharded chain with the ppermute halo;
                audio within 2e-4 after block 0, decim[0] within 1e-6,
                power_in (the psum of the ranks' K2 sums) within rtol 1e-6;
                K2 and K7 launches counted on every rank.
                sharded-channelizer: Monitor(mesh=...) on a (1, 4) mesh at
                presets.channelizer_61m44(4096), global T=8388608 (F_local
                512), for 2 blocks in three forms: "xla" (the preset, AM on;
                K5 with the torch AGC completion, K3 for frame -1), "emit_env"
                (enabled_modes (0, 1, 3, 4); K5's emit_env variant) and the
                two-kernel fused form (fuse_single_pass off: K3, the
                all_to_all of the planes, K4 at 1024 channels), each against
                the unsharded port Monitor on the card: audio within 2e-4
                after block 0, waterfall 1e-2 dB, channel power rtol 1e-4, the
                gathered state (cw_phase bit-equal, pfb 1e-6, the rest 2e-4 of
                scale); host ms per block per rank, and the all_to_all's ms.
                sharded-duplex: ShardedDuplex on (1, 4) at C=128 and (2, 2) at
                C=64, T=131072 (RX: NB, NR, notch and VAD at depth 1 through
                K2 with the rdma halo, K7; TX: the mic EQ and LSB channels)
                for 4 blocks, K2 and K7 counted on every rank; each block held
                against the unsharded DuplexChain on the card stepped from the
                same gathered state: RX audio within 2e-4 after block 0, TX
                IQ within 5e-4, VAD flags equal, the FM phase within 2e-3 as
                phasors, the NCOs bit-equal; and the unsharded chain run free
                from the initial state: after block k (from 1) the FM phase
                within k x 5e-4 as phasors and the TX IQ within 5e-4 +
                (k - 1) x 5e-4 (F3: the float32 integrators' drift, which
                the JAX package shares).
                mesh-checkpoint: Radio(mesh=(1, 4)) on the sharded slice (K2
                + K7) at C=128 and Monitor(mesh=(1, 4)) in the emit_env form
                at F_local 512 run 2 blocks, save (gathered, written by rank
                0), run 2 more; a fresh object loads and runs the same 2
                blocks bit-equal on every rank; the checkpoint loaded into an
                unsharded object on the card continues within 2e-4 of the
                sharded run. make_hybrid_mesh(1, 2, device="cuda") with
                LOCAL_WORLD_SIZE=2 (two "hosts" on the one card): the
                host-major rank layout, one ShardedRxChain step bit-equal to
                make_mesh(2, 2)'s
  6e. stream    BlockStream at the flagship (K1) over 8 numpy blocks (pinned
                staging, the next block's copy on a side stream) bit-equal,
                audio and state, to a loop of RxChain.step; int16 words
                through CaptureSource(raw_i16=True) (the native ring, HAVE_NATIVE
                required) -> BlockStream -> step_i16, bit-equal to step_i16
                on the same words, no overrun
  6f. transceiver  Transceiver at C=128 (the duplex configuration with
                split, RIT, XIT, VFO B on receive, SAM sent as AM) for 4
                blocks, PTT up and down: the live half bit-equal to
                DuplexChain.step with the Transceiver's words, the other half
                zero; then CatTcpServer over a stream on the card: FA/MD, TX
                and RX from a TCP client take effect by the next block
  6f2. graphs   each chain step the APIs capture (the K1 chain, the K2 + K6
                slice, TxChain at tx_adc_r1280, DuplexChain, ChannelizerChain
                through K5 and through K3 -> K4) as CompiledStep, one CUDA
                graph replayed a block, against its eager step over 4 seeded
                blocks with a retune before block 2 and block 1's state
                assigned back before block 3: every output and the state
                bit-equal; then Radio, Monitor, Transceiver and BlockStream
                (donate=False) with a tune, a mode change, PTT and save/load
                (or the state put back) against their chains' eager steps.
                Each run: one capture, a replay a block, each kernel
                launched once a block and once in the capture's warm-up.
                Every API run of the phases before and after is held to the
                same counts
  6g. checkpoint  Radio (flagship, K1) and Monitor (channelizer_61m44(4096),
                K5): 2 blocks, save, 2 more; a fresh object loads and runs
                the same 2 blocks bit-equal
  6h. pipeline  PipelinedRx on two streams of the card, 8 blocks at C=128,
                T=131072: the flagship (K1 front, dense back end) and the
                slice (K2 front, K6 back), audio and state against
                sequential RxChain.step (2e-4 after block 0's 512 warm-up
                samples; bit-equal reported); host ms a block pipelined and
                sequential (median of 5 after 3 warm-ups) and the device
                busy share of each
  6i. digital   the FT8 decode batched over 4096 channel slots (seeded
                messages at 12 kHz, noise sigma 2; 4096 x 151,680 float32,
                2.49 GB): symbol_energies -> soft_bits -> decode_llrs (40
                min-sum iterations), every row decoded to its message, 64 rows
                against the CPU (LLRs 1e-4 of scale, hard bits and ok equal),
                its CUDA-event ms, the min-sum's share and its launches; the
                FT8 skimmer (PfbChannelizer, M=32, three signals) decoded on
                the card; a clean WSPR round trip; Radio.capabilities()
  6j. cli       python -m radioframe_torch.cli rx on an SSB capture WAV on
                the card and with --device cpu (exit 0, SNR above 20 dB and
                within 1 dB of the CPU's), cli monitor --channels 4096 on one
                block of 8,388,608 samples (exit 0, the tone's channel
                first), cli info (its FT8/WSPR lines), and
                examples/torch_{channelizer,duplex,golden_rx,monitor}_demo.py
                with --device cuda at their default sizes
  6k. trace     diag.timing.trace(dir, device="cuda") around 2 blocks each
                of the flagship Radio (K1), the slice Radio (K2 + K6) and the
                single-pass Monitor on channelizer_61m44(4096) (K5); the
                written plugins/profile/<stamp>/<host>.trace.json.gz read
                back: fused_frontend2_kernel, fused_frontend_kernel,
                ols_demod_kernel and channelizer_one_kernel each among its
                events of cat "kernel"; the six device events with the most
                summed time printed beside the card; the launches counted
  7. time       CUDA-event medians: RxChain.step, K1, plain front end; the
                slice's RxChain.step, K2, K6, their plain versions, each K8
                variant and the dense back end K6 replaces; the slice step's
                profile (device work, span, activities by name);
                ChannelizerChain.step single-pass / two-kernel / dense, K3,
                K4, K5 (and its emit_env variant) and their plain versions,
                torch.fft.fft over the
                (F, M) planes as the DFT stage's yardstick; host-clock
                medians of Radio.process (both configurations) and
                Monitor.process (all before phases 8-9: a step's time
                depends on the host); K1 on int16 counts beside its bound;
                K1 at (32, 8) at adc_rate_r1280's shapes (C=128, T=655360)
                beside its plain version and its bound; every chain step's
                host ms a block (a synchronize a block) eager and replayed
                as a CUDA graph, in turns
  7a. tx-time   CUDA-event medians of TxChain.step at tx_adc_r1280 (output IQ
                samples/s), DuplexChain.step at the duplex row (RX input
                samples/s) and both RX-options steps, each with its device
                busy share and device activities per step; each one's host
                ms a block eager and as a CUDA graph
  7c. api-time  host-clock medians (5 runs after 3 warm-ups) of
                Radio.process (flagship) and Monitor.process (4096 channels)
                through the pinned staging, the same steps behind the
                earlier pageable copies (and plane split), and
                BlockStream.run per block over the same block; each API
                path also with the eager step in place of its CUDA graph
  7b. parent    with the parent commit's sources in $RF_PARENT_CSRC (default
                build/parent/csrc): K1, K2, K3, K9's pfb_only and
                batched_b3, K4, K5 (each at its own walk S), K5 emit_env at
                F_local=512 and K6, each built beside this tree's and timed
                in turns (parent, change, change, parent; device time and
                CUDA events) on the same inputs, with their largest output
                difference (relative to each output's scale, at least 1); K3,
                K4, K6, and K5 and K5 emit_env at the same S, held bit-equal
                to the parent's; the single-pass chain's (M, F) audio: this
                tree's K5 against the parent's K5 and the transposed copy
                after it; the parent's registers (ptxas) and resident blocks
                beside this tree's, and the SASS of K4, K6 and K5's
                frame-major instantiations compared with the parent's;
                skipped, and said so, without them
  8. audio      SSB/AM/NFM captures through the card's flagship chain and
                the slice configuration, SNR above 20 dB and within 1 dB of
                the same chain on the CPU
  9. ch-audio   an AM tone at channel 37 through the card's single-pass
                channelizer, SNR above 15 dB and within 1 dB of the CPU's
  10. loopback  SSB, AM and NFM from the card's TxChain into its RxChain
                (tests/test_tx_chain.py's loopback): SNR above 25, 15 and 15
                dB and within 1 dB of the same loopback on the CPU

Any failed check raises, and the script exits non-zero. The last two lines
are the kernel table and {"ok": true, "device": {...}} as JSON.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import gzip
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import radioframe_torch.native as native
from radioframe_torch.api.cat import CatServer
from radioframe_torch.api.cat_tcp import CatTcpServer
from radioframe_torch.api.monitor import Monitor
from radioframe_torch.api.radio import Radio
from radioframe_torch.api.transceiver import Transceiver
from radioframe_torch.core import presets
from radioframe_torch.core import compiled
from radioframe_torch.core.compiled import CompiledStep, clone_tree
from radioframe_torch.core.stream import BlockStream, CaptureSource, Stager
from radioframe_torch.core.config import AgcConfig, CicStage, FirStage, RxConfig, TxConfig
from radioframe_torch.diag import timing
from radioframe_torch.diag.metrics import audio_snr_db
from radioframe_torch.io import fixtures as FX
from radioframe_torch.io.wav import read_wav, write_wav
from radioframe_torch.kernels import _build
from radioframe_torch.kernels import channelizer_one as K5_MOD
from radioframe_torch.kernels import demod_agc as K4_MOD
from radioframe_torch.kernels import fused_frontend as K2_MOD
from radioframe_torch.kernels import fused_frontend2 as K1_MOD
from radioframe_torch.kernels import pfb_dft as K3_MOD
from radioframe_torch.kernels import ols_demod as K6_MOD
from radioframe_torch.kernels.channelizer_one import (FusedChannelizerOne,
                                                      plain_channelizer_one)
from radioframe_torch.kernels.demod_agc import FusedDemodAgc, plain_demod_agc
from radioframe_torch.kernels.fused_frontend import VARIANTS, FusedFrontend, plain_fused_frontend
from radioframe_torch.kernels.fused_frontend2 import FusedFrontend2, plain_step
from radioframe_torch.kernels.ols_demod import FusedOlsDemod, plain_call_chain, plain_ols_demod
from radioframe_torch.kernels import frontend_plan, pfb_plan
from radioframe_torch.kernels.halo_dma import (HaloDma, plain_ring_halo, ring_halo_dma,
                                               stream_mem_ops)
from radioframe_torch.kernels.pfb_dft import VARIANTS as PFB_VARIANTS
from radioframe_torch.kernels.pfb_dft import FusedPfbDft, plain_pfb_dft, plain_variant
from radioframe_torch.ops import filter_design as FD
from radioframe_torch.ops import ft8, nco, wspr
from radioframe_torch.ops.agc import AgcBank
from radioframe_torch.ops.demod import AM, CW, LSB, MODE_NAMES as MODE_CODES, NFM, SSB, filter_index
from radioframe_torch.ops.pfb import PfbChannelizer
from radioframe_torch.pipelines.channelizer import ChannelizerChain, _pack_backend_state
from radioframe_torch.pipelines.duplex import DuplexChain
from radioframe_torch.pipelines.rx_chain import RxChain
from radioframe_torch.pipelines.tx_chain import TxChain
from radioframe_torch.shard.duplex import ShardedDuplex
from radioframe_torch.shard.mesh import (gather_state, make_hybrid_mesh, make_mesh, shard_state,
                                         spawn)
from radioframe_torch.shard.pipeline import PipelinedRx
from radioframe_torch.shard.rx import ShardedRxChain

C_FLAG = 128
T_FLAG = 131072
FS_IN = 1_536_000.0
SEED = 0
FRONTEND_TOL = 5e-4  # the reference's on-chip front-end bound (VERIFY_TPU_r05 tol)
FLAG_NFM_PERIOD = 19.2  # fs_audio / deviation = 48 kHz / 2.5 kHz: an atan2 branch flip
CHAIN_TOL = 2e-4     # chain audio after block 0 (the bound of tests/test_fused_frontend.py)
SNR_TOL_DB = 1.0     # BASELINE's audio bar
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TF32_OPS_PER_S = 495e12    # H100 SXM TF32 on the tensor cores, dense
SOURCES = ("fused_frontend2", "fused_frontend", "pfb_dft", "demod_agc", "channelizer_one",
           "ols_demod", "halo_dma")  # csrc/<name>.cu
KERNELS = {  # name -> (source, TPU kernel it replaces), in the kernel line's order
    "fused_frontend2": ("radioframe_torch/kernels/csrc/fused_frontend2.cu",
                        "radioframe/kernels/fused_frontend2.py:49"),
    "fused_frontend": ("radioframe_torch/kernels/csrc/fused_frontend.cu",
                       "radioframe/kernels/fused_frontend.py:48"),
    "fused_frontend_variants": ("radioframe_torch/kernels/csrc/fused_frontend.cu",
                                "tools/probe_fused.py:38"),
    "pfb_dft": ("radioframe_torch/kernels/csrc/pfb_dft.cu", "radioframe/kernels/pfb_dft.py:157"),
    "demod_agc": ("radioframe_torch/kernels/csrc/demod_agc.cu",
                  "radioframe/kernels/demod_agc.py:85"),
    "channelizer_one": ("radioframe_torch/kernels/csrc/channelizer_one.cu",
                        "radioframe/kernels/channelizer_one.py:46"),
    "ols_demod": ("radioframe_torch/kernels/csrc/ols_demod.cu",
                  "radioframe/kernels/ols_demod.py:113"),
    "halo_dma": ("radioframe_torch/kernels/csrc/halo_dma.cu", "radioframe/kernels/halo_dma.py:27"),
    "pfb_dft_variants": ("radioframe_torch/kernels/csrc/pfb_dft.cu",
                         "tools/probe_pfbdft_stages.py:48"),
    "channelizer_one_emit_env": ("radioframe_torch/kernels/csrc/channelizer_one.cu",
                                 "radioframe/kernels/channelizer_one.py:46"),
}
# config 5 (BASELINE), as bench.py's bench_channelizer times it
CH_M, CH_K = 4096, 8
CH_T = 128 * 65536  # 128 x min_block: F = 2048 frames per channel, 136.5 ms of air
CH_TOL = 2e-4       # audio after block 0 and carry rows (relative to each row's scale)
CH_PLANE_TOL = 2e-4  # K3 planes, relative to max |y|
WF_TOL_DB = 1e-2
NFM_PERIOD = 6.0    # fs_channel / deviation = 15 kHz / 2.5 kHz: an atan2 branch flip


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of the bytes over
    the memory rate and the operations over the FP32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def flagship_config(channels: int | None = None, fused: bool = True) -> RxConfig:
    """bench.py main()'s flagship RX chain (128 channels unless given)."""
    return RxConfig(
        fs_in=FS_IN, channels=C_FLAG if channels is None else channels,
        stages=(CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
        ols_hop=512, fuse_frontend=fused, fuse_frontend_depth=2,
        enabled_modes=(0, 1, 2, 3))


def slice_config(channels: int | None = None) -> RxConfig:
    """The flagship with the depth-1 fused front end (K2) and the fused OLS +
    demod + AGC back end (K6)."""
    return dataclasses.replace(flagship_config(channels), fuse_frontend_depth=1,
                               fuse_backend=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _binding(inputs) -> tuple:
    """The buffers a ``CompiledStep`` call reads in place: (address, shape,
    strides, dtype) of each tensor input on the card, None for the others
    (what the step copies)."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                 if isinstance(t, torch.Tensor) and t.is_cuda else None
                 for t in compiled.leaves(inputs))


def _record_bindings() -> None:
    """From now on every ``CompiledStep`` keeps the set of the bindings its
    calls were fed (``fed``), for _check_replayed to hold its captures to."""
    if getattr(CompiledStep.__call__, "records", False):
        return
    call = CompiledStep.__call__

    def recorded(self, *inputs):
        self.__dict__.setdefault("fed", set()).add(_binding(inputs))
        return call(self, *inputs)

    recorded.records = True
    CompiledStep.__call__ = recorded


def _check_replayed(what: str, cs: CompiledStep, blocks: int, launches: dict) -> None:
    """A captured step's run of ``blocks`` blocks went through its graphs (one
    signature; a capture for each distinct binding of its device inputs it
    was fed, none of them past ``BIND_CAP`` or in the step's own memory; a
    replay a block) and each kernel of ``launches`` launched once a block and
    once in the signature's warm-up."""
    fed = cs.__dict__.get("fed")
    check(fed is not None, f"{what}: the bindings were not recorded (_record_bindings)")
    check(cs.signatures == 1 and cs.captures == len(fed) <= compiled.BIND_CAP
          and cs.replays == blocks == cs.blocks,
          f"{what}: {cs.captures} captures of {cs.signatures} signatures for {len(fed)} "
          f"bindings fed, {cs.replays} replays for {blocks} blocks")
    for k, n in launches.items():
        check(n == blocks + cs.signatures, f"{what}: {k} launched {n} times for {blocks} "
                                           f"blocks and {cs.signatures} warm-up")


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


def host_ms(fn, runs: int = 5, warmup: int = 3) -> float:
    """Host-clock median of ``fn()`` over ``runs`` calls after ``warmup``
    (``fn`` ends with a copy to the host, so the clock sees the device's
    work)."""
    times = []
    for i in range(warmup + runs):
        t0 = time.perf_counter()
        fn()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_both_ways(what: str, step, state, inputs, label: str) -> dict:
    """Host ms a block (host clock, each block ending in a synchronize) of
    ``step`` run eagerly and replayed as a CUDA graph (CompiledStep), in
    turns (_turns_ms); printed on a [time] line."""
    st = [clone_tree(state)]
    cs = CompiledStep(step, clone_tree(state), device=inputs[0].device, name=what)

    def eager():
        with torch.no_grad():
            st[0] = step(st[0], *inputs)[0]
        torch.cuda.synchronize()

    def graph():
        cs(*inputs)
        torch.cuda.synchronize()

    ms = _turns_ms({"eager": eager, "graph": graph})
    print(f"[time] {what}: host ms a block, eager step {ms['eager']:.4f}, CUDA graph "
          f"{ms['graph']:.4f} (host clock, medians of 5 in turns after 3 warm-ups; {label})")
    return ms


def device_events(run, activities=(torch.profiler.ProfilerActivity.CUDA,)) -> list:
    """The device activities (kernels and copies) of ``run()``, traced by
    torch.profiler after a traced warm-up ``run()`` whose events are
    dropped: a fresh trace loses its first device activity."""
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=list(activities), schedule=sched) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    trace = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith("ProfilerStep")]  # the schedule's own range
    check(bool(trace), "the profiler traced no device activity")
    return trace


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn`` (every CUDA kernel it launches), from
    torch.profiler over ``n`` calls after 3 warm-up calls: unlike an event
    pair around the calls, it does not count the host's time between them."""
    for _ in range(3):
        fn()
    kernels = device_events(lambda: [fn() for _ in range(n)])
    return sum(e.time_range.elapsed_us() for e in kernels) / (1e3 * n)


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
    ops = stream_mem_ops(torch.device("cuda", 0))
    print(f"[device] CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS: {int(ops)}")
    check(ops, "the card cannot wait on 64-bit values from a stream (K7's ordering)")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build_all(list(SOURCES))
    print(f"[build] {len(built)} kernel sources in {time.perf_counter() - t0:.2f} s wall "
          "(one nvcc each, in parallel)")
    for name, b in built.items():
        print(f"[build] {b.path.name}: nvcc {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print(f"[build] {name}: {line.strip()}")


def _kernel_cases(dev):
    """(label, front end, C, T, input form): the flagship's input forms —
    separate f32 planes, the interleaved complex view the chain passes, int16
    counts, a shared (1, T) wideband input — then the per-thread copy path:
    int16 rows of T + 3 samples (2-byte row starts) and f32 planes viewed
    one column in; then ragged last chunks in single-stage mode (R2 = 1)
    and with decimation 2x2 (the default RxConfig's stage plan); then
    adc_61m44's plan, (R1, R2) = (32, 8), at bench.py's adc_rate_r1280
    shapes (C=128, T=655360): K1's run-time instantiation."""
    flag = RxChain(flagship_config())._stage_taps
    small = RxChain(RxConfig(channels=5, fuse_frontend=True, fuse_frontend_depth=2))._stage_taps
    adc = RxChain(presets.adc_61m44(C_FLAG, fuse_frontend=True, fuse_frontend_depth=2))
    k1 = lambda **kw: FusedFrontend2(flag[0], 8, flag[1], 4, **kw).to(dev)  # noqa: E731
    i16 = 2.0 ** -15
    return [
        ("f32", k1(), C_FLAG, T_FLAG, "f32"),
        ("complex view", k1(), C_FLAG, T_FLAG, "complex"),
        ("int16", k1(input_scale=i16), C_FLAG, T_FLAG, "int16"),
        ("wideband", k1(), C_FLAG, T_FLAG, "wideband"),
        ("int16 rows of T+3", k1(input_scale=i16), C_FLAG, T_FLAG, "int16 odd rows"),
        ("f32 column offset", k1(), C_FLAG, T_FLAG, "column offset"),
        ("single-stage ragged", FusedFrontend2(flag[0], 8).to(dev), 5, 20000, "f32"),
        ("decim 2x2 ragged", FusedFrontend2(small[0], 2, small[1], 2).to(dev), 5, 20000, "f32"),
        ("adc_61m44 32x8", adc.fused.to(dev), C_FLAG, adc.min_block, "f32"),
    ]


def _planes(rng, form: str, C: int, T: int, dev):
    """(xr, xi) of one block in the given input form."""
    if form.startswith("int16"):
        pad = 3 if form == "int16 odd rows" else 0
        x = np.clip(np.round(rng.standard_normal((2, C, T + pad)) * 8000.0), -32768, 32767)
        x = torch.from_numpy(x.astype(np.int16)).to(dev)
        return x[0, :, pad:], x[1, :, pad:]
    if form == "complex":
        x = rng.standard_normal((C, T, 2)).astype(np.float32)
        iq = torch.view_as_complex(torch.from_numpy(x).to(dev))
        planes = torch.view_as_real(iq)
        return planes[..., 0], planes[..., 1]
    pad = 1 if form == "column offset" else 0
    rows = 1 if form == "wideband" else C
    x = torch.from_numpy(rng.standard_normal((2, rows, T + pad)).astype(np.float32)).to(dev)
    return x[0, :, pad:], x[1, :, pad:]


def phase_kernel(dev, blocks: int = 2) -> float:
    """K1 against plain_step on the card, each case's plan printed; both copy
    paths (TMA bulk and per-thread cp.async) must run. Returns the largest
    |y| difference."""
    rng = np.random.default_rng(SEED)
    worst = 0.0
    copies = set()
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
            copies.add(ff.last_plan.copy)
            print(f"[kernel] {label} block {blk}: plan {frontend_plan.describe(ff.last_plan)}; "
                  f"y {tuple(y_k.shape)} max|err| {err:.3e} (scale {float(y_p.abs().max()):.3f}), "
                  f"power rel {p_rel:.2e}, acc and tail bit-equal")
    check({"bulk", "async"} <= copies, f"K1 copy paths run: {sorted(copies)}")
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
    _check_replayed("slice", radio._compiled, blocks, {"K1": launches})
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


# --- the slice: K2 with K8's variants, and K6 ----------------------------------------------


def _k2_cases(dev):
    """(label, front end, C, T, input form): the flagship's first stage with
    f32 planes, the interleaved complex view the chain passes and a shared
    (1, T) input (the TMA bulk copy path), f32 planes viewed one column in
    (the per-thread cp.async path), adc_61m44's CIC(32, 4) (125 taps, J0 =
    4) at C=5, and a ragged last chunk."""
    flag = RxChain(flagship_config())._stage_taps[0]
    return [
        ("f32", FusedFrontend(flag, 8).to(dev), C_FLAG, T_FLAG, "f32"),
        ("complex view", FusedFrontend(flag, 8).to(dev), C_FLAG, T_FLAG, "complex"),
        ("wideband", FusedFrontend(flag, 8).to(dev), C_FLAG, T_FLAG, "wideband"),
        ("f32 column offset", FusedFrontend(flag, 8).to(dev), C_FLAG, T_FLAG, "column offset"),
        ("R=32", FusedFrontend(FD.cic_equivalent_taps(32, 4, 1), 32).to(dev), 5, 32 * 3000,
         "f32"),
        ("ragged", FusedFrontend(flag, 8).to(dev), 5, 20000, "f32"),
    ]


def phase_k2_kernel(dev, blocks: int = 2) -> float:
    """K2 against plain_fused_frontend on the card, each launch's plan
    printed, y bit-equal (or within FRONTEND_TOL) and the power sum within
    rtol 1e-6; both copy paths (TMA bulk and per-thread cp.async) must run.
    Returns the largest |y| difference."""
    rng = np.random.default_rng(SEED + 4)
    worst = 0.0
    copies = set()
    for label, ff, C, T, form in _k2_cases(dev):
        words_np = nco.freq_word(np.linspace(-5e5, 5e5, C), FS_IN)
        words_np[0] = 2 ** 31 - 7  # acc + word*T wraps every block
        words = torch.from_numpy(words_np).to(dev)
        st_k, st_p = ff.init_state(C), ff.init_state(C)
        acc_np = np.zeros(C, np.int64)
        for blk in range(blocks):
            xr, xi = _planes(rng, form, C, T, dev)
            before = ff.launches
            st_k, y_k, p_k = ff.step_planes(st_k, xr, xi, words, return_power=True)
            check(ff.launches == before + 1, f"K2 {label}: launch counter")
            y_p, p_p = plain_fused_frontend(ff, xr, xi, st_p["tail"], st_p["acc"], words)
            st_p = ff.next_state(st_p, xr, xi, words)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            p_rel = float(((p_k - p_p).abs() / p_p.abs()).max())
            worst = max(worst, err)
            acc_np = (acc_np + words_np.astype(np.int64) * T + 2 ** 31) % 2 ** 32 - 2 ** 31
            tail_ref = torch.complex(xr[:, T - ff.H:], xi[:, T - ff.H:]).expand(C, -1)
            check(err <= FRONTEND_TOL, f"K2 {label} block {blk}: max|y_k - y_plain| {err:.3g}")
            check(p_rel <= 1e-6, f"K2 {label} block {blk}: power rel err {p_rel:.3g}")
            check(np.array_equal(st_k["acc"].cpu().numpy(), acc_np.astype(np.int32)),
                  f"K2 {label} block {blk}: acc")
            check(torch.equal(st_k["tail"], tail_ref), f"K2 {label} block {blk}: tail")
            copies.add(ff.last_plan.copy)
            print(f"[k2-kernel] {label} block {blk}: plan {frontend_plan.describe(ff.last_plan)}; "
                  f"y {tuple(y_k.shape)} (R={ff.R}, J0={ff.J0}) max|err| {err:.3e}"
                  f"{' (bit-equal)' if torch.equal(y_k, y_p) else ''} (scale "
                  f"{float(y_p.abs().max()):.3f}), power rel {p_rel:.2e}, acc and tail bit-equal")
    check({"bulk", "async"} <= copies, f"K2 copy paths run: {sorted(copies)}")
    return worst


def phase_k8(dev) -> float:
    """K8's five variants at K8's shapes (C=128, T=131072, R=8, J0=4) against
    their plain versions, ``full`` bit-equal to K2; returns the largest
    difference relative to each output's scale (>= 1)."""
    rng = np.random.default_rng(SEED + 5)
    ff = FusedFrontend(RxChain(flagship_config())._stage_taps[0], 8).to(dev)
    xr, xi = _planes(rng, "f32", C_FLAG, T_FLAG, dev)
    words = torch.from_numpy(nco.freq_word(np.linspace(-5e5, 5e5, C_FLAG), FS_IN)).to(dev)
    tail = torch.from_numpy(rng.standard_normal((2, C_FLAG, ff.H)).astype(np.float32)).to(dev)
    st = {"acc": torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, C_FLAG, dtype=np.int32)).to(dev),
          "tail": torch.complex(tail[0], tail[1])}
    _, y_k2 = ff.step_planes(st, xr, xi, words)
    worst = 0.0
    for v in VARIANTS:
        before = ff.variant_launches[v]
        _, y_k = ff.step_planes(st, xr, xi, words, variant=v)
        check(ff.variant_launches[v] == before + 1, f"K8 {v}: launch counter")
        y_p, _ = plain_fused_frontend(ff, xr, xi, st["tail"], st["acc"], words, v)
        torch.cuda.synchronize()
        scale = max(1.0, float(y_p.abs().max()))
        err = float((y_k - y_p).abs().max()) / scale
        worst = max(worst, err)
        check(err <= FRONTEND_TOL, f"K8 {v}: max|y_k - y_plain| {err:.3g} of scale {scale:.3g}")
        same = bool(torch.equal(y_k, y_k2))
        if v == "full":
            check(same, "K8 full is not bit-equal to K2")
        print(f"[k8] {v}: plan {frontend_plan.describe(ff.last_plan)}; max|err| {err:.3e} of "
              f"scale {scale:.3f}{'; bit-equal to K2' if same else ''}")
    return worst


def _audio_iq(rng, C: int, Ta: int, blk: int) -> np.ndarray:
    """(C, Ta) complex64 at the audio rate: a tone per channel (so a carrier
    in every NFM channel) under a light noise floor, continuous across
    blocks."""
    t = (blk * Ta + np.arange(Ta)) / 48_000.0
    x = np.exp(2j * np.pi * (1000.0 + 37.0 * np.arange(C))[:, None] * t)
    x += 0.05 * (rng.standard_normal((C, Ta)) + 1j * rng.standard_normal((C, Ta)))
    return x.astype(np.complex64)


def _k6_blocks(dev, rng, C: int, label: str, mode_cfgs, segments: int | None = None,
               blocks: int = 2, tag: str = "k6-kernel") -> float:
    """K6 at C channels (Ta=4096, nfft=1024, hop=512, modes SSB/CW/AM/NFM/LSB)
    against plain_ols_demod over ``blocks`` chained blocks, its walk in
    ``segments`` time segments (None: walk_plan's default). Returns the
    largest audio difference held (after block 0)."""
    bank = RxChain(slice_config()).to(dev).mode_bank
    fs_a, Ta = 48_000.0, T_FLAG // 32
    modes = np.arange(C) % 5
    k6 = FusedOlsDemod(bank.nfft, bank.hop, C, fs_a, 2500.0).to(dev)
    k6.walk_segments = segments
    mode, word, rel, al, tgt, mg = _consts(C, fs_a, mode_cfgs, modes, dev)
    h_sel = bank._H.index_select(0, filter_index(mode).to(torch.int64))
    zero_tail = torch.zeros((C, bank.nfft - bank.hop), dtype=torch.complex64, device=dev)
    st = {"k": (zero_tail, _carry0(C, dev)), "p": (zero_tail, _carry0(C, dev))}
    acc = np.zeros(C, np.int64)
    worst = 0.0
    for blk in range(blocks):
        x = torch.from_numpy(_audio_iq(rng, C, Ta, blk)).to(dev)
        consts = (mode, word, torch.from_numpy(acc.astype(np.int32)).to(dev), rel, al, tgt, mg)
        before = k6.launches
        a_k, s_k, t_k = k6(st["k"][0], x, h_sel, *consts, st["k"][1])
        check(k6.launches == before + 1, "K6 launch counter")
        a_p, s_p, t_p = plain_ols_demod(k6, st["p"][0], x, h_sel, *consts, st["p"][1])
        torch.cuda.synchronize()
        check(a_k.shape == (C, Ta) and bool(torch.isfinite(a_k).all()),
              f"K6 {label}: audio shape/finite")
        aerr = np.abs(_nfm_mod((a_k - a_p).cpu().numpy(), modes, FLAG_NFM_PERIOD))
        # an NFM channel's AGC envelope (rows 4-5) is unused and latches
        # the discriminator's ill-conditioned values while the OLS fills
        # (the reference's TestFusedBackend excludes it likewise)
        keep = torch.ones((7, C), dtype=torch.bool, device=dev)
        keep[4:6, torch.from_numpy(modes == NFM).to(dev)] = False
        c_err = _carry_err(torch.where(keep, s_k, 0.0), torch.where(keep, s_p, 0.0))
        plan = k6.last_plan
        what = f"K6 C={C} {label} block {blk}"
        if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
            check(aerr.max() <= CHAIN_TOL, f"{what}: audio {aerr.max():.3g}")
            worst = max(worst, float(aerr.max()))
        check(c_err <= CH_TOL, f"{what}: carry {c_err:.3g}")
        check(torch.equal(t_k, t_p), f"{what}: OLS tail")
        print(f"[{tag}] {what}: walk S={plan.segments} L={plan.length}; audio max|d| by mode "
              f"{_by_mode(aerr, modes)}{' (cold start, not held)' if blk == 0 else ''}; carry "
              f"{c_err:.2e} (relative); tail bit-equal")
        st = {"k": (t_k, s_k), "p": (t_p, s_p)}
        acc = (acc + int(word[0]) * Ta + 2 ** 31) % 2 ** 32 - 2 ** 31
    return worst


def phase_k6_kernel(dev) -> float:
    """K6 against plain_ols_demod on the card at the flagship back end's
    shapes (C=128, Ta=4096, nfft=1024, hop=512) with instant and nonzero
    attack, and at C=5; modes SSB/CW/AM/NFM/LSB. Returns the largest audio
    difference held (after block 0)."""
    rng = np.random.default_rng(SEED + 6)
    (_, instant, _), (_, attack, _) = _agc_cases()[:2]
    return max(_k6_blocks(dev, rng, C, label, cfgs)
               for C, label, cfgs in ((C_FLAG, "instant attack", instant),
                                      (C_FLAG, "nonzero attack", attack),
                                      (5, "instant attack", instant)))


def _slice_iq(rng, freqs: np.ndarray, modes: np.ndarray, blk: int) -> np.ndarray:
    """(C, T) complex64: unit complex noise plus, in every NFM channel, a
    carrier at its tuned frequency (continuous across blocks). On noise
    alone the discriminator divides by |X| near 0, where rounding is
    magnified without bound."""
    C = len(freqs)
    iq = (rng.standard_normal((C, T_FLAG), np.float32)
          + 1j * rng.standard_normal((C, T_FLAG), np.float32)).astype(np.complex64)
    n = blk * T_FLAG + np.arange(T_FLAG)
    for ch in np.flatnonzero(modes == NFM):
        iq[ch] += np.exp(2j * np.pi * freqs[ch] * n / FS_IN).astype(np.complex64)
    return iq


def _plain_rx_twin(cfg, dev) -> RxChain:
    """The slice chain with K2 and K6 replaced by their plain versions."""
    twin = RxChain(cfg).to(dev)
    twin.fused._launch = functools.partial(plain_fused_frontend, twin.fused)
    twin.backend_kernel._launch = functools.partial(plain_ols_demod, twin.backend_kernel)
    twin.backend_kernel._launch_chain = functools.partial(plain_call_chain, twin.backend_kernel)
    return twin


def phase_rx_slice(dev, blocks: int = 4) -> dict:
    """Radio on the slice configuration through K2 and K6 for 4 blocks, held
    against the chain built from the plain versions; the K1 chain and the
    dense chain reported beside it. Returns each kernel's launches in the
    Radio's run."""
    cfg = slice_config()
    radio = Radio(cfg, device=dev)
    names = ("ssb", "cw", "am", "nfm")
    freqs = np.linspace(-5e5, 5e5, C_FLAG)
    for ch, f in enumerate(freqs):
        radio.tune(ch, float(f))
        radio.set_mode(ch, names[ch % 4])
    chains = {"plain": _plain_rx_twin(cfg, dev), "K1": RxChain(flagship_config()).to(dev),
              "dense": RxChain(flagship_config(fused=False)).to(dev)}
    states = {k: c.init_state() for k, c in chains.items()}
    words = torch.from_numpy(nco.freq_word(radio._freqs, FS_IN)).to(dev)
    modes = torch.from_numpy(radio._modes).to(dev)
    rng = np.random.default_rng(SEED + 7)
    iq = [_slice_iq(rng, freqs, radio._modes, b) for b in range(blocks)]
    k2, k6 = radio.chain.fused, radio.chain.backend_kernel
    k2.launches = k6.launches = 0
    k2.variant_launches = dict.fromkeys(VARIANTS, 0)
    audio, power = [], []
    for x in iq:
        audio.append(radio.process(x))
        power.append(radio.metrics()["power_in"])
    launches = {"fused_frontend": k2.launches, "ols_demod": k6.launches,
                "fused_frontend_variants": k2.variant_launches["full"]}
    _check_replayed("rx-slice", radio._compiled, blocks, {"K2": k2.launches, "K6": k6.launches})
    for blk, (x, a) in enumerate(zip(iq, audio)):
        xd = torch.from_numpy(x).to(dev)
        out = {}
        with torch.no_grad():
            for k, c in chains.items():
                states[k], a_k, aux = c.step(states[k], xd, words, modes)
                out[k] = np.abs(_nfm_mod(a - a_k.cpu().numpy(), radio._modes, FLAG_NFM_PERIOD))
                if k == "plain":
                    p_plain = aux["power_in"].cpu().numpy()
        check(a.shape == (C_FLAG, T_FLAG // cfg.decim) and bool(np.isfinite(a).all()),
              f"block {blk}: audio shape {a.shape} / finite")
        # power_in: K2's per-strip sums against the plain version's one sum
        p_rel = float(np.max(np.abs(power[blk] - p_plain) / p_plain))
        check(p_rel <= 1e-6, f"block {blk}: power_in rel {p_rel:.3g} against the plain chain")
        err = float(out["plain"].max())
        if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
            check(err <= CHAIN_TOL, f"block {blk}: K2+K6 chain vs plain chain {err:.3g}")
        beside = "; ".join(f"vs {k} chain by mode: " + ", ".join(
            f"{n} {out[k][radio._modes == m].max():.2e}" for m, n in enumerate(names))
            for k in ("K1", "dense"))
        print(f"[rx-slice] block {blk}: audio {a.shape} finite; max|K2+K6 chain - plain chain| "
              f"{err:.3e}{' (cold start, not held)' if blk == 0 else ''}; power_in rel "
              f"{p_rel:.2e}; {beside}")
    print(f"[rx-slice] launches in the main path: {launches} "
          f"(K8's entry counts K2's full-variant launches)")
    return launches


def _captures(n: int):
    ssb, ssb_truth = FX.ssb_capture(FS_IN, n, 100_000.0)
    am, am_truth = FX.am_capture(FS_IN, n, -200_000.0)
    nfm, nfm_truth = FX.nfm_capture(FS_IN, n, 300_000.0)
    wide = (ssb + am + nfm).astype(np.complex64)
    return wide, [("ssb", 100_000.0, ssb_truth), ("am", -200_000.0, am_truth),
                  ("nfm", 300_000.0, nfm_truth)]


def _score(device, make_cfg, wide, rows, blocks: int) -> list[float]:
    radio = Radio(make_cfg(channels=len(rows)), device=device)
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
    """The captures through the flagship (K1) and the slice (K2 + K6)
    configurations, on the card and on the CPU."""
    wide, rows = _captures(blocks * T_FLAG)
    for label, make_cfg in (("K1 chain", flagship_config), ("K2+K6 chain", slice_config)):
        card = _score(dev, make_cfg, wide, rows, blocks)
        cpu = _score("cpu", make_cfg, wide, rows, blocks)
        for (mode, f, _), s_card, s_cpu in zip(rows, card, cpu):
            print(f"[audio] {label} {mode.upper():3s} @ {f / 1e3:+.0f} kHz: SNR card "
                  f"{s_card:.2f} dB, cpu {s_cpu:.2f} dB, delta {s_card - s_cpu:+.3f} dB")
            check(abs(s_card - s_cpu) <= SNR_TOL_DB, f"{label} {mode} SNR card vs cpu")
            check(s_card > 20.0, f"{label} {mode} SNR {s_card:.1f} dB")


def phase_time(dev, label: str) -> dict:
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

    ff16 = FusedFrontend2(*chain._stage_taps[:1], ff.R, chain._stage_taps[1], ff.R2,
                          input_scale=2.0 ** -15).to(dev)
    x16 = torch.randint(-8000, 8000, (2, C_FLAG, T_FLAG), generator=g, device=dev,
                        dtype=torch.int16)
    with torch.no_grad():
        ms_chain = median_ms(chain_step)
        # the kernel through _launch (y and the power sum), without the
        # state update's small torch ops
        ms_k1 = median_ms(lambda: ff._launch(xr, xi, fst["tail"], fst["acc"], words))
        ms_plain = median_ms(lambda: plain_step(ff, xr, xi, fst["tail"], fst["acc"], words))
        ms_i16 = median_ms(lambda: ff16._launch(x16[0], x16[1], fst["tail"], fst["acc"], words))
    ms_radio = _radio_ms(cfg, iq.cpu().numpy(), dev)
    host_both_ways("RxChain.step (K1 chain)", chain.step, chain.init_state(), (iq, words, modes),
                   label)
    n = C_FLAG * T_FLAG
    for what, ms in (("RxChain.step", ms_chain), ("K1 fused_frontend2", ms_k1),
                     ("K1 fused_frontend2 int16", ms_i16), ("plain front end", ms_plain),
                     ("Radio.process (host clock)", ms_radio)):
        print(f"[time] {what}: {ms:.4f} ms/block, {n / (ms * 1e-3):.4g} IQ samples/s "
              f"({label})")
    print(f"[time] K1 plan: {frontend_plan.describe(ff.last_plan)}; int16: "
          f"{frontend_plan.describe(ff16.last_plan)}")
    # K1's least work: the planes in (8 B a sample, 4 for int16), the raw tail,
    # the taps, y and power out; per input sample 6 mix flops + sincos (2) +
    # power (4), then 4 flops per stage-1 and stage-2 tap
    ops = n * (12 + 4 * (ff.J0 + 1) + 4 * (ff.J2 + 1) / ff.R)
    rows = {}
    for name, per_sample, ms in (("K1", 8, ms_k1), ("K1 int16", 4, ms_i16)):
        nbytes = per_sample * n + 8 * C_FLAG * ff.H_carry + 4 * (ff.w1.numel() + ff.w2.numel()) \
            + 8 * n // ff.decim + 12 * C_FLAG
        rows[name] = bound(nbytes, ops)
        print(f"[time] {name} bound: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP -> "
              f"{rows[name][0]:.4f} ms ({rows[name][1]}); kernel at {rows[name][0] / ms:.1%} of it")
    _k1_adc_time(dev, g, label)
    bound_ms, bound_by = rows["K1"]
    return {"ms": ms_k1, "plain_ms": ms_plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _k1_adc_time(dev, g, label: str) -> None:
    """K1's (R1, R2) = (32, 8) instantiation at adc_rate_r1280's shapes (C=128,
    T=655360, f32 planes, 671 MB in): CUDA-event ms of the kernel and of its
    plain version, and its bound."""
    ff = RxChain(presets.adc_61m44(C_FLAG, fuse_frontend=True,
                                   fuse_frontend_depth=2)).fused.to(dev)
    T = 655_360
    xr = torch.randn((C_FLAG, T), generator=g, device=dev)
    xi = torch.randn((C_FLAG, T), generator=g, device=dev)
    words = torch.from_numpy(nco.freq_word(np.linspace(-2e7, 2e7, C_FLAG), 61.44e6)).to(dev)
    st = ff.init_state(C_FLAG)
    with torch.no_grad():
        ms = median_ms(lambda: ff._launch(xr, xi, st["tail"], st["acc"], words))
        ms_plain = median_ms(lambda: plain_step(ff, xr, xi, st["tail"], st["acc"], words),
                             runs=5, inner=3)
    n = C_FLAG * T
    ops = n * (12 + 4 * (ff.J0 + 1) + 4 * (ff.J2 + 1) / ff.R)
    nbytes = 8 * n + 8 * C_FLAG * ff.H_carry + 4 * (ff.w1.numel() + ff.w2.numel()) \
        + 8 * n // ff.decim + 12 * C_FLAG
    b_ms, b_by = bound(nbytes, ops)
    print(f"[time] K1 (32, 8) at adc_rate_r1280 (C={C_FLAG}, T={T}): {ms:.4f} ms/block, plain "
          f"{ms_plain:.4f}; bound {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP -> {b_ms:.4f} ms "
          f"({b_by}), kernel at {b_ms / ms:.1%} of it; plan "
          f"{frontend_plan.describe(ff.last_plan)} ({label})")


# --- the parent's kernels beside this tree's, in turns ---------------------------------------

# the sources of the commit this tree is measured against (K1, K2, K4, K5, K6),
# with their shared headers: $RF_PARENT_CSRC, else build/parent/csrc, e.g.
# filled by
#   git show <commit>:radioframe_torch/kernels/csrc/<file> > build/parent/csrc/<file>
PARENT_CSRC = Path(os.environ.get("RF_PARENT_CSRC",
                                  Path(__file__).resolve().parent / "build/parent/csrc"))
PARENT_CALLS = 100  # profiled calls per turn: fewer leave the turns' device times 20% apart
PARENT_SOURCES = ("fused_frontend2", "fused_frontend", "pfb_dft", "demod_agc", "channelizer_one",
                  "ols_demod")


def _build_parent() -> dict | None:
    """The parent's PARENT_SOURCES built from PARENT_CSRC (one nvcc each, in
    parallel) into build/parent/lib: {name: (CDLL, ptxas log)}, or None
    without them."""
    if not all((PARENT_CSRC / f"{n}.cu").is_file() for n in PARENT_SOURCES):
        return None
    out = PARENT_CSRC.parent / "lib"
    out.mkdir(parents=True, exist_ok=True)

    def one(name):
        so = out / f"{name}.so"
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                               str(PARENT_CSRC / f"{name}.cu")], capture_output=True, text=True,
                              check=True)
        return ctypes.CDLL(str(so)), proc.stdout + proc.stderr

    with ThreadPoolExecutor(max_workers=len(PARENT_SOURCES)) as pool:
        return dict(zip(PARENT_SOURCES, pool.map(one, PARENT_SOURCES)))


def _swapped(mod, attr: str, fn, make):
    """``make`` with ``mod.<attr>`` (a kernel wrapper's cached library
    entry) returning ``fn`` for the call: the wrapper, its checks and its
    plan around another build of the same C interface."""
    def call():
        shipped = getattr(mod, attr)
        setattr(mod, attr, lambda: fn)
        try:
            return make()
        finally:
            setattr(mod, attr, shipped)
    return call


def _ptxas_registers(log: str, kernel: str) -> str:
    """The registers ptxas gave each instantiation of ``kernel``, from an
    nvcc -Xptxas -v log."""
    regs, current = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = kernel in line
        elif current and "registers" in line:
            regs.append(re.search(r"Used (\d+) registers", line).group(1))
            current = None
    return "/".join(regs) or "not in the log"


def _sass(lib: Path) -> dict:
    """{function: its SASS instructions, without addresses and encodings}
    of ``lib`` (cuobjdump -sass); a name's anonymous namespace without the
    hash of its file's text."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = funcs.setdefault(re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name), [])
        elif current is not None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
            if m:
                current.append(m.group(1))
    return funcs


def _frame_major_sass() -> dict:
    """The walk's frame-major code (K4, K6, and K5 as the sharded paths and
    emit_env launch it) of the parent's build (build/parent/lib) against
    this tree's, instruction for instruction; K5's channel-major
    instantiations left out. Returns {source: identical}."""
    out = {}
    for src in ("demod_agc", "ols_demod", "channelizer_one"):
        par = _sass(PARENT_CSRC.parent / "lib" / f"{src}.so")
        chg = {n.replace("ELb0EE", "EE"): body
               for n, body in _sass(_build.build(src).path).items() if "ELb1EE" not in n}
        diff = {n: sum(a != b for a, b in zip(body, chg.get(n, []))) + abs(len(body) - len(chg.get(n, [])))
                for n, body in par.items()}
        out[src] = len(chg) == len(par) and not any(diff.values())
        print(f"[parent] {src}: SASS of the parent's {len(par)} function(s) "
              f"{'identical to' if out[src] else 'differs from'} this tree's frame-major build "
              f"({sum(map(len, par.values()))} instructions; differing by function {diff})")
    return out


def _max_diff(a, b) -> float:
    """The largest output difference, relative to each output's scale (>= 1)."""
    return max(float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
               for x, y in zip(a, b) if x.shape == y.shape and x.numel())


def phase_parent(dev, label: str) -> dict:
    """Device time (torch.profiler) and CUDA-event time of the parent's build
    and this tree's of K1 (flagship, the interleaved view the chain passes),
    K2 (the slice's front end on the same view), K3, K9's dft_only (rf::fft
    alone, unchanged: the spread of the turns), pfb_only and
    batched_b3 (config 5, M=4096, F=2048), K4, K5, K5 emit_env at the
    sharded path's F_local=512, K6, and K5's (M, F) audio against the
    parent's K5 and the transposed copy after it, in turns parent, change,
    change, parent, each pair on the same inputs, with their largest output
    difference; K3, K4, K5, K5 emit_env and K6 must be bit-equal to the
    parent's.
    Every parent build has this tree's C interface and runs inside this
    tree's wrapper (its checks, plan and walk S); a parent whose interface
    differs needs an adapter of its own here. The parent's K3 and K5
    registers (ptxas) are printed beside this tree's. Skipped, and said so,
    without the parent's sources. Returns {name: (parent ms, change ms)}."""
    libs = _build_parent()
    if libs is None:
        print(f"[parent] no parent sources at {PARENT_CSRC}: parent comparison skipped")
        return {}
    runs = {}
    # K1: the flagship front end on the chain's interleaved view; the parent's
    # C interface is this tree's
    chain = RxChain(flagship_config()).to(dev)
    ff = chain.fused
    g = torch.Generator(device=dev).manual_seed(SEED)
    iq = torch.complex(torch.randn((C_FLAG, T_FLAG), generator=g, device=dev),
                       torch.randn((C_FLAG, T_FLAG), generator=g, device=dev))
    planes = torch.view_as_real(iq)
    xr, xi = planes[..., 0], planes[..., 1]
    words = torch.from_numpy(nco.freq_word(np.linspace(-5e5, 5e5, C_FLAG), FS_IN)).to(dev)
    fst = ff.init_state(C_FLAG)
    lib1 = libs["fused_frontend2"][0]
    fns1 = {}
    for dtype, sym in ((torch.float32, "rf_fused_frontend2_f32"),
                       (torch.int16, "rf_fused_frontend2_i16")):
        fns1[dtype] = getattr(lib1, sym)
        fns1[dtype].argtypes = K1_MOD._kernel_fns()[dtype].argtypes
        fns1[dtype].restype = ctypes.c_int
    k1 = lambda: ff._launch(xr, xi, fst["tail"], fst["acc"], words)  # noqa: E731
    runs["K1 f32 complex view"] = (_swapped(K1_MOD, "_kernel_fns", fns1, k1), k1)
    # K2: the slice's front end on the same view; the parent's C interface is
    # this tree's
    k2 = RxChain(slice_config()).to(dev).fused
    st2 = k2.init_state(C_FLAG)
    fn2 = libs["fused_frontend"][0].rf_fused_frontend
    fn2.argtypes, fn2.restype = K2_MOD._kernel_fn().argtypes, ctypes.c_int
    make2 = lambda: k2._launch(xr, xi, st2["tail"], st2["acc"], words)  # noqa: E731
    runs["K2 f32 complex view"] = (_swapped(K2_MOD, "_kernel_fn", fn2, make2), make2)
    # K3, K9, K4, K5, K6 at their main paths' shapes
    cfg = presets.channelizer_61m44(CH_M)
    two = ChannelizerChain(dataclasses.replace(cfg, fuse_single_pass=False)).to(dev)
    one = ChannelizerChain(cfg).to(dev)
    k3, k4, k5 = two.pfb, two.demod_kernel, one.one_kernel
    wr = torch.randn(CH_T, generator=g, device=dev)
    wi = torch.randn(CH_T, generator=g, device=dev)
    tail = k3.init_state(1)
    (yr, yi), _ = k3.step_planes(tail, wr, wi)
    mode = torch.arange(CH_M, device=dev, dtype=torch.int32) % 4
    rel, al, tgt, mg = one.agc_bank.per_channel(mode)
    word = torch.full((CH_M,), one.cw_tone_word, dtype=torch.int32, device=dev)
    consts = (mode, word, torch.zeros_like(word), rel, al, tgt, mg)
    st0 = _carry0(CH_M, dev)
    k5e = _emit_env_k5().to(dev)
    mode_e = torch.from_numpy(EMIT_MODES.astype(np.int32)).to(dev)
    consts_e = (mode_e, word, torch.zeros_like(word), *one.agc_bank.per_channel(mode_e))
    n_loc = CH_T // SHARD_RANKS
    sym3 = libs["pfb_dft"][0].rf_pfb_dft
    sym3.argtypes, sym3.restype = K3_MOD._kernel_fn().argtypes, ctypes.c_int
    for v, name in (("base_b3", "K3 M=4096 F=2048"), ("dft_only", "K9 dft_only"),
                    ("pfb_only", "K9 pfb_only"), ("pfb_noshift", "K9 pfb_noshift"),
                    ("batched_b3", "K9 batched_b3")):
        make3 = lambda v=v: k3._launch(tail, wr, wi, v)  # noqa: E731
        runs[name] = (_swapped(K3_MOD, "_kernel_fn", sym3, make3), make3)
    sym5 = libs["channelizer_one"][0].rf_channelizer_one
    types5 = K5_MOD._kernel_fn().argtypes
    fn5 = sym5
    if "channel_major" not in (PARENT_CSRC / "channelizer_one.cu").read_text():
        # a parent that writes frame-major only: its entry lacks the layout
        # argument (the one before the stream)
        sym5.argtypes = types5[:-2] + types5[-1:]

        def fn5(*args):
            check(args[-2] == 0, "the parent's K5 asked for channel-major audio")
            return sym5(*args[:-2], args[-1])
    else:
        sym5.argtypes = types5
    sym5.restype = ctypes.c_int
    for name, kern, x_r, x_i, c in (("K5 M=4096 F=2048", k5, wr, wi, consts),
                                    ("K5 emit_env F_local=512", k5e, wr[:n_loc], wi[:n_loc],
                                     consts_e)):
        make5 = (lambda kern=kern, x_r=x_r, x_i=x_i, c=c:  # noqa: E731
                 kern.call_planes(tail, x_r, x_i, *c, st0))
        runs[name] = (_swapped(K5_MOD, "_kernel_fn", fn5, make5), make5)
    # the single-pass chain's audio: the parent's K5 and the transposed copy
    # after it, against this tree's K5 writing (M, F)
    fm5 = lambda: k5.call_planes(tail, wr, wi, *consts, st0)  # noqa: E731
    runs["K5 M=4096 F=2048 (M, F) audio"] = (
        _swapped(K5_MOD, "_kernel_fn", fn5,
                 lambda: (lambda o: (o[0].T.contiguous(),) + o[1:])(fm5())),
        lambda: k5.call_planes(tail, wr, wi, *consts, st0, channel_major=True))
    for src, kernel in (("pfb_dft", "pfb_cluster_kernel"),
                        ("channelizer_one", "channelizer_one_kernel")):
        print(f"[parent] {src}: {kernel} registers (ptxas) parent "
              f"{_ptxas_registers(libs[src][1], kernel)}, change "
              f"{_ptxas_registers(_build.build(src).log, kernel)} ({label})")
    _frame_major_sass()
    for name, mod, make in (
            ("K4 M=4096 F=2048", K4_MOD, lambda: k4(yr, yi, *consts, st0)),
            ("K6 C=128 Ta=4096", K6_MOD, _k6_timing_call(dev))):
        src = mod.__name__.rsplit(".", 1)[1]
        sym = getattr(libs[src][0], "rf_" + src)
        sym.argtypes, sym.restype = mod._kernel_fn().argtypes, ctypes.c_int
        runs[name] = (_swapped(mod, "_kernel_fn", sym, make), make)
    out = {}
    with torch.no_grad():
        for name, (par, chg) in runs.items():
            a, b = par(), chg()
            torch.cuda.synchronize()
            diff = _max_diff(a, b)
            if name.startswith(("K3", "K4", "K5", "K6")):
                check(diff == 0.0, f"{name}: differs from the parent's by {diff:.3g} of scale")
            dev_t = [device_ms(f, n=PARENT_CALLS) for f in (par, chg, chg, par)]
            ev_t = [median_ms(f) for f in (par, chg, chg, par)]
            out[name] = (statistics.mean(ev_t[::3]), statistics.mean(ev_t[1:3]))
            print(f"[parent] {name}: device ms parent/change/change/parent "
                  f"{'/'.join(f'{t:.4f}' for t in dev_t)}; CUDA events "
                  f"{'/'.join(f'{t:.4f}' for t in ev_t)}; max|change - parent| {diff:.2e} of scale "
                  f"({label})")
    return out


def profile_steps(step, label: str, card: str, n: int = 5, top: int = 6) -> dict:
    """torch.profiler over ``n`` calls of ``step`` after ``n`` warm-up calls:
    prints device busy time, span and busy share per step, and the ``top``
    device activities by time; returns {"busy_ms", "span_ms", "activities"}
    per step."""
    acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    with torch.no_grad():
        for _ in range(n):
            step()
        # device activity only (kernels and copies, one stream: they do not overlap)
        trace = device_events(lambda: [step() for _ in range(n)], acts)
    by_name = {}
    for e in trace:
        total, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), calls + 1)
    busy_us = sum(t for t, _ in by_name.values())
    span_us = (max(e.time_range.end for e in trace) - min(e.time_range.start for e in trace)
               if trace else 0.0)
    print(f"[profile] {n} {label}: device busy {busy_us / (n * 1e3):.4f} ms per step, "
          f"device span {span_us / (n * 1e3):.4f} ms per step, busy share "
          f"{busy_us / max(span_us, 1e-9):.1%}, {len(trace) // n} device activities per step "
          f"({card})")
    for name, (total, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]   {name[:70]}: {total / (n * 1e3):.4f} ms per step, "
              f"{calls // n} per step")
    return {"busy_ms": busy_us / (n * 1e3), "span_ms": span_us / (n * 1e3),
            "activities": len(trace) // n}


def _k6_timing_call(dev):
    """One K6 launch at the slice's shapes (C=128, Ta=4096, instant attack)
    on its front end's output: a closure for phase_parent."""
    chain = RxChain(slice_config()).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    iq = torch.complex(torch.randn((C_FLAG, T_FLAG), generator=g, device=dev),
                       torch.randn((C_FLAG, T_FLAG), generator=g, device=dev))
    words = torch.from_numpy(nco.freq_word(np.linspace(-5e5, 5e5, C_FLAG), FS_IN)).to(dev)
    modes = torch.arange(C_FLAG, device=dev, dtype=torch.int32) % 4
    with torch.no_grad():
        fstate, bstate = chain.split_state(chain.init_state())
        _, x, _ = chain.step_front(fstate, iq, words)
    d = bstate["demod"]
    args = (bstate["bpf"], x, chain.mode_bank._H.index_select(0, filter_index(modes).long()),
            modes, torch.full((C_FLAG,), chain.cw_tone_word, dtype=torch.int32, device=dev),
            d["cw_phase"], *chain.agc_bank.per_channel(modes),
            _pack_backend_state(d, bstate["agc"]))
    return lambda: chain.backend_kernel(*args)


def _k2_work(ff: FusedFrontend, C: int, T: int) -> tuple[float, float]:
    """(bytes, FP32 operations) K2 must at least move and do: f32 planes in,
    the raw tail and the taps, y and the power sums out; per input sample the
    mix (6), the sincos (2) and the power (4), per output 4 flops per tap."""
    nbytes = 8 * C * T + 8 * C * ff.H + 4 * ff.w1.numel() + 8 * C * (T // ff.R) + 4 * C
    return nbytes, C * T * (12 + 4 * (ff.J0 + 1))


def _k6_work(k6: FusedOlsDemod, C: int, Ta: int, modes: np.ndarray) -> tuple[float, float]:
    """(bytes, FP32 operations) K6 must at least move and do: x, the OLS tail,
    the selected responses, the per-channel constants and the carry in, audio
    and the carry out; a forward and an inverse FFT (5 N log2 N each)
    and the product per frame, then per sample |x|^2 (3), the demod value by
    mode, the AM DC block (4) and the AGC (10)."""
    nfft, F = k6.nfft, Ta // k6.hop
    nbytes = 8 * C * (Ta + nfft - k6.hop + nfft) + 4 * C * Ta + 4 * C * (7 + 2 * 7)
    ops = C * F * (2 * 5 * nfft * np.log2(nfft) + 6 * nfft)
    ops += Ta * sum(3 + MODE_OPS[int(m)] + 4 + 10 for m in modes)
    return nbytes, float(ops)


def _radio_ms(cfg, block: np.ndarray, dev) -> float:
    """Host-clock median of Radio.process over 5 blocks after 3 warm-up
    blocks (numpy in, numpy out: ends after the device-to-host copy)."""
    radio = Radio(cfg, device=dev)
    for ch, f in enumerate(np.linspace(-5e5, 5e5, cfg.channels)):
        radio.tune(ch, float(f))
        radio.set_mode(ch, ("ssb", "cw", "am", "nfm")[ch % 4])
    return host_ms(lambda: radio.process(block))


def phase_slice_time(dev, label: str) -> dict:
    """ms per block (CUDA events) of the slice's RxChain.step, K2, each K8
    variant, K6, their plain versions and the dense back end K6 replaces
    (apply_selected, bank_apply and AgcBank on the same x); Radio.process on
    the host clock; each kernel's bound."""
    cfg = slice_config()
    chain = RxChain(cfg).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    iq = torch.complex(torch.randn((C_FLAG, T_FLAG), generator=g, device=dev),
                       torch.randn((C_FLAG, T_FLAG), generator=g, device=dev))
    words = torch.from_numpy(nco.freq_word(np.linspace(-5e5, 5e5, C_FLAG), FS_IN)).to(dev)
    modes_np = np.arange(C_FLAG) % 4
    modes = torch.from_numpy(modes_np.astype(np.int32)).to(dev)
    state = [chain.init_state()]

    def chain_step():
        state[0], _, _ = chain.step(state[0], iq, words, modes)

    ff, k6 = chain.fused, chain.backend_kernel
    fst = ff.init_state(C_FLAG)
    planes = torch.view_as_real(iq)
    xr, xi = planes[..., 0], planes[..., 1]
    ms = {}
    with torch.no_grad():
        ms["RxChain.step (slice)"] = median_ms(chain_step)
        # the kernels through _launch: step_planes adds the state update's
        # small torch ops, whose host time would pace the measurement
        kern = (xr, xi, fst["tail"], fst["acc"], words)
        ms["fused_frontend"] = median_ms(lambda: ff._launch(*kern))
        ms["fused_frontend plain"] = median_ms(lambda: plain_fused_frontend(ff, *kern))
        for v in VARIANTS:
            ms[f"K8 {v}"] = median_ms(lambda v=v: ff._launch(*kern, v))
            ms[f"K8 {v} plain"] = median_ms(lambda v=v: plain_fused_frontend(ff, *kern, v))
        fstate, bstate = chain.split_state(chain.init_state())
        _, x, pw = chain.step_front(fstate, iq, words)
        d = bstate["demod"]
        args = (bstate["bpf"], x, chain.mode_bank._H.index_select(0, filter_index(modes).long()),
                modes, torch.full((C_FLAG,), chain.cw_tone_word, dtype=torch.int32, device=dev),
                d["cw_phase"], *chain.agc_bank.per_channel(modes),
                _pack_backend_state(d, bstate["agc"]))
        ms["ols_demod"] = median_ms(lambda: k6(*args))
        ms["ols_demod plain"] = median_ms(lambda: plain_ols_demod(k6, *args))
        ab = chain.agc_bank
        ms["ols_demod chain form"] = median_ms(lambda: k6.call_chain(
            bstate["bpf"], x, chain.mode_bank._H, modes,
            (ab.release, ab.alpha, ab.target, ab.max_gain), chain.cw_tone_word, d, bstate["agc"]))
        ms["dense back end"] = median_ms(lambda: chain._step_back_composed(bstate, x, modes, pw))
    ms["Radio.process (slice, host clock)"] = _radio_ms(cfg, iq.cpu().numpy(), dev)
    host_both_ways("RxChain.step (slice)", chain.step, chain.init_state(), (iq, words, modes),
                   label)
    # the step's device work and activities: K2 sums power_in as it reads the
    # block, so no other activity reads the full-rate input
    profile_steps(chain_step, "slice RxChain.step", label, top=50)
    n = C_FLAG * T_FLAG
    for what, t in ms.items():
        print(f"[time] {what}: {t:.4f} ms/block, {n / (t * 1e-3):.4g} IQ samples/s ({label})")
    rows = {}
    for name, (nbytes, ops) in (("fused_frontend", _k2_work(ff, C_FLAG, T_FLAG)),
                                ("ols_demod", _k6_work(k6, C_FLAG, x.shape[-1], modes_np))):
        b_ms, b_by = bound(nbytes, ops)
        print(f"[time] {name} bound: {nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP -> "
              f"{b_ms:.4f} ms ({b_by}); kernel at {b_ms / ms[name]:.1%} of it")
        rows[name] = {"ms": ms[name], "plain_ms": ms[f"{name} plain"], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}
    rows["ols_demod"]["dense_backend_ms"] = ms["dense back end"]
    rows["fused_frontend_variants"] = {
        **rows["fused_frontend"], "ms": ms["K8 full"], "plain_ms": ms["K8 full plain"],
        "variants_ms": {v: ms[f"K8 {v}"] for v in VARIANTS},
        "variants_plain_ms": {v: ms[f"K8 {v} plain"] for v in VARIANTS}}
    return rows

# --- config 4: the transmit chain and full duplex; the RX options ------------------------------

TX_C, TX_BLOCKS = 64, 3     # bench.py's tx_adc_r1280: 64 channels, Ta = 512 -> 655,360 IQ out
TX_TOL = 5e-4               # TX IQ on unit scale (the reference's tests/test_sharded_tx.py)
FM_PHASE_TOL = 2e-3         # the FM phase as phasors (the same test)
# rad a block: run free, the sharded and unsharded float32 FM phase integrators
# drift apart by at most this per block, both packages alike (F3; the bound of
# tests/test_torch_sharded_tx.py::test_fm_phase_drift_rate_matches_jax)
FM_DRIFT_PER_BLOCK = 5e-4
TX_EQ = ((300.0, 3.0, 1.0), (2500.0, 6.0, 2.0))
EQ_C = 8
TX_NAMES = ("ssb", "cw", "am", "nfm", "lsb")
DPX_BLOCKS = 4
RX_OPTIONS = {"nb nr notch vad": dict(nb_enabled=True, nr_enabled=True, notch_enabled=True,
                                      vad_enabled=True),
              "deemphasis squelch": dict(nfm_deemphasis_s=531e-6, squelch_enabled=True)}
LOOP_BARS = {"ssb": 25.0, "am": 15.0, "nfm": 15.0}  # tests/test_tx_chain.py's loopback bars


def tx_config(channels: int = TX_C, **kw) -> TxConfig:
    """bench.py's tx_adc_r1280: 48 kHz audio -> 61.44 Msps (L = 5 * 8 * 32)."""
    return presets.tx_adc_61m44(channels=channels, **kw)


def duplex_configs(channels: int = C_FLAG, **tx_kw) -> tuple[RxConfig, TxConfig]:
    """bench.py's duplex: the flagship RX (K1 at depth 2) and its adjoint TX,
    48 kHz -> 1.536 Msps by FIR(4) then CIC(8, 4)."""
    return flagship_config(channels), TxConfig(fs_out=FS_IN, channels=channels,
                                               interp_stages=(4, CicStage(R=8, N=4)), **tx_kw)


def rx_options_config(variant: str, channels: int | None = None, **kw) -> RxConfig:
    """The flagship RX (K1 and the dense back end) with one variant's options."""
    return dataclasses.replace(flagship_config(channels), **RX_OPTIONS[variant], **kw)


def _tx_inputs(rng, C: int, Ta: int, blocks: int) -> list:
    return [(0.3 * rng.standard_normal((C, Ta))).astype(np.float32) for _ in range(blocks)]


def _fm_iq(rng, freqs: np.ndarray, modes: np.ndarray, blocks: int) -> list:
    """(C, T_FLAG) complex64 blocks: unit complex noise plus, in every NFM
    channel, a carrier at its tuned frequency frequency-modulated by band-
    limited noise (2.5 kHz peak deviation), continuous across blocks. The
    auto-notch nulls a bare carrier, which would leave the discriminator on
    noise; a modulated one is a band it leaves alone."""
    n = blocks * T_FLAG
    c = np.cumsum(rng.standard_normal(n + 256))
    m = c[256:] - c[:-256]
    phase = np.cumsum(2 * np.pi * 2500.0 / FS_IN * m / np.abs(m).max())
    t = np.arange(n)
    out = []
    for b in range(blocks):
        x = (rng.standard_normal((len(freqs), T_FLAG), np.float32)
             + 1j * rng.standard_normal((len(freqs), T_FLAG), np.float32)).astype(np.complex64)
        s = slice(b * T_FLAG, (b + 1) * T_FLAG)
        for ch in np.flatnonzero(modes == NFM):
            x[ch] += 4.0 * np.exp(1j * (2 * np.pi * freqs[ch] * t[s] / FS_IN + phase[s]))
        out.append(x)
    return out


def _subset(modes: np.ndarray, n_modes: int) -> np.ndarray:
    """The first channel of each mode: the rows run again on the CPU."""
    return np.array([int(np.flatnonzero(modes == m)[0]) for m in range(n_modes)])


def _dev(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@torch.no_grad()
def _tx_run(chain: TxChain, audio: list, words, modes, dev) -> tuple[list, dict]:
    st = chain.init_state(len(modes))
    w, m = _dev(words, dev), _dev(modes, dev)
    out = []
    for a in audio:
        st, iq = chain.step(st, _dev(a, dev), w, m)
        out.append(iq)
    return out, st


def phase_tx(dev) -> None:
    """TxChain at tx_adc_r1280 (C=64, Ta=512, L=1280: 335.5 MB of IQ a block)
    for 3 blocks, every mode (arange(64) % 5), and with a mic EQ at C=8; the
    first channel of each mode run again by the port on the CPU: IQ within
    TX_TOL, the FM phase within FM_PHASE_TOL as phasors, the NCO bit-equal."""
    for label, cfg in (("tx_adc_r1280", tx_config()),
                       ("tx_adc_r1280 mic eq", tx_config(EQ_C, mic_eq_bands=TX_EQ))):
        C = cfg.channels
        rng = np.random.default_rng(SEED + 30)
        audio = _tx_inputs(rng, C, 512, TX_BLOCKS)
        words = nco.freq_word(np.linspace(-20e6, 20e6, C), cfg.fs_out)
        modes = (np.arange(C) % 5).astype(np.int32)
        rows = _subset(modes, 5)
        card = TxChain(cfg).to(dev)
        iq_card, st_card = _tx_run(card, audio, words, modes, dev)
        iq_cpu, st_cpu = _tx_run(TxChain(cfg), [a[rows] for a in audio], words[rows],
                                 modes[rows], "cpu")
        for blk, (x, y) in enumerate(zip(iq_card, iq_cpu)):
            check(x.shape == (C, 512 * cfg.interp) and bool(torch.isfinite(x).all()),
                  f"{label} block {blk}: IQ shape {tuple(x.shape)} / finite")
            d = (x[_dev(rows, dev)].cpu() - y).abs().amax(dim=-1).numpy()
            check(float(d.max()) <= TX_TOL, f"{label} block {blk}: card vs cpu {d.max():.3g}")
            print(f"[tx] {label} block {blk}: IQ {tuple(x.shape)} ({x.numel() * 8 / 1e6:.1f} MB) "
                  f"finite; max|card - cpu| by mode: "
                  + ", ".join(f"{n} {e:.2e}" for n, e in zip(TX_NAMES, d)))
        ph = np.exp(1j * st_card["fm_phase"][_dev(rows, dev)].cpu().numpy())
        ph_err = float(np.abs(ph - np.exp(1j * st_cpu["fm_phase"].numpy())).max())
        check(ph_err <= FM_PHASE_TOL, f"{label}: fm_phase {ph_err:.3g}")
        check(torch.equal(st_card["nco"][_dev(rows, dev)].cpu(), st_cpu["nco"]),
              f"{label}: the NCO accumulator")
        print(f"[tx] {label}: fm_phase as phasors {ph_err:.2e}; NCO bit-equal")


@torch.no_grad()
def _duplex_run(dpx: DuplexChain, iq: list, audio: list, rx_words, rx_modes, tx_words,
                tx_modes, dev) -> tuple[list, dict]:
    st = dpx.init_state(len(rx_modes))
    args = [_dev(a, dev) for a in (rx_words, rx_modes, tx_words, tx_modes)]
    out = []
    for x, a in zip(iq, audio):
        st, rx_audio, tx_iq, aux = dpx.step(st, _dev(x, dev), _dev(a, dev), *args)
        out.append((rx_audio, tx_iq, aux))
    return out, st


def _duplex_inputs(C: int):
    rng = np.random.default_rng(SEED + 31)
    freqs = np.linspace(-5e5, 5e5, C)
    rx_modes = (np.arange(C) % 4).astype(np.int32)
    tx_modes = (np.arange(C) % 5).astype(np.int32)
    iq = [_slice_iq(rng, freqs, rx_modes, b) for b in range(DPX_BLOCKS)]
    audio = _tx_inputs(rng, C, T_FLAG // 32, DPX_BLOCKS)
    words = nco.freq_word(freqs, FS_IN)
    return iq, audio, words, rx_modes, words, tx_modes


def phase_duplex(dev) -> int:
    """DuplexChain at bench.py's duplex row (C=128, T=131072; TX Ta=4096,
    every mode) for 4 blocks, K1's count set to 0 just before and read just
    after; one channel of each mode run again on the CPU: RX audio within
    CHAIN_TOL after block 0 (NFM modulo fs/deviation), TX IQ within TX_TOL.
    Returns K1's launches."""
    rx_cfg, tx_cfg = duplex_configs()
    iq, audio, rxw, rxm, txw, txm = _duplex_inputs(C_FLAG)
    dpx = DuplexChain(rx_cfg, tx_cfg).to(dev)
    dpx.rx.fused.launches = 0
    out, _ = _duplex_run(dpx, iq, audio, rxw, rxm, txw, txm, dev)
    launches = dpx.rx.fused.launches
    check(launches == DPX_BLOCKS, f"duplex: K1 launched {launches} times for {DPX_BLOCKS} blocks")
    rows = _subset(txm, 5)
    ref, _ = _duplex_run(DuplexChain(rx_cfg, tx_cfg), [x[rows] for x in iq],
                         [a[rows] for a in audio], rxw[rows], rxm[rows], txw[rows], txm[rows],
                         "cpu")
    for blk, ((a, x, _), (a_c, x_c, _)) in enumerate(zip(out, ref)):
        check(a.shape == (C_FLAG, T_FLAG // 32) and x.shape == (C_FLAG, T_FLAG)
              and bool(torch.isfinite(a).all()) and bool(torch.isfinite(x).all()),
              f"duplex block {blk}: shapes / finite")
        r = _dev(rows, dev)
        ea = np.abs(_nfm_mod(a[r].cpu().numpy() - a_c.numpy(), rxm[rows], FLAG_NFM_PERIOD))
        ex = (x[r].cpu() - x_c).abs().amax(dim=-1).numpy()
        if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
            check(float(ea.max()) <= CHAIN_TOL,
                  f"duplex block {blk}: RX card vs cpu {ea.max():.3g}")
        check(float(ex.max()) <= TX_TOL, f"duplex block {blk}: TX card vs cpu {ex.max():.3g}")
        print(f"[duplex] block {blk}: RX audio {tuple(a.shape)}, TX IQ {tuple(x.shape)} finite; "
              f"max|card - cpu| RX {ea.max():.2e}{' (cold start, not held)' if blk == 0 else ''}, "
              "TX by mode " + ", ".join(f"{n} {e:.2e}" for n, e in zip(TX_NAMES, ex)))
    print(f"[duplex] K1 launches in the duplex path: {launches}")
    return launches


def phase_rx_options(dev) -> int:
    """RxChain on the flagship with each RX_OPTIONS variant (K1 and the dense
    back end) at C=128, T=131072 for 4 blocks, FM carriers in the NFM
    channels, K1's count set to 0 just before and read just after; the first
    channel of each mode run again on the CPU: audio within CHAIN_TOL after
    block 0, VAD flags equal. Returns K1's launches over both variants."""
    freqs = np.linspace(-5e5, 5e5, C_FLAG)
    modes = (np.arange(C_FLAG) % 4).astype(np.int32)
    rows = _subset(modes, 4)
    total = 0
    for variant in RX_OPTIONS:
        cfg = rx_options_config(variant)
        iq = _fm_iq(np.random.default_rng(SEED + 32), freqs, modes, DPX_BLOCKS)
        card, cpu = RxChain(cfg).to(dev), RxChain(cfg)
        st, st_c = card.init_state(), cpu.init_state(len(rows))
        w, m = nco.freq_word(freqs, FS_IN), modes
        card.fused.launches = 0
        out = []
        with torch.no_grad():
            for x in iq:
                st, a, aux = card.step(st, _dev(x, dev), _dev(w, dev), _dev(m, dev))
                out.append((a, aux))
        launches = card.fused.launches
        check(launches == DPX_BLOCKS, f"rx options {variant}: K1 launched {launches} times")
        total += launches
        for blk, (x, (a, aux)) in enumerate(zip(iq, out)):
            with torch.no_grad():
                st_c, a_c, aux_c = cpu.step(st_c, _dev(x[rows], "cpu"), _dev(w[rows], "cpu"),
                                            _dev(m[rows], "cpu"))
            check(bool(torch.isfinite(a).all()), f"rx options {variant} block {blk}: finite")
            r = _dev(rows, dev)
            e = np.abs(_nfm_mod(a[r].cpu().numpy() - a_c.numpy(), m[rows], FLAG_NFM_PERIOD))
            vad = ""
            if "vad_active" in aux:
                v, v_c = aux["vad_active"][r].cpu(), aux_c["vad_active"]
                check(torch.equal(v, v_c), f"rx options {variant} block {blk}: VAD flags "
                                           f"differ in {int((v != v_c).sum())} frames")
                vad = f"; VAD flags equal ({int(v.sum())} of {v.numel()} voiced)"
            if blk > 0:  # block 0: cold-start AGC, NR and VAD transients
                check(float(e.max()) <= CHAIN_TOL,
                      f"rx options {variant} block {blk}: card vs cpu {e.max():.3g}")
            print(f"[rx-options] {variant} block {blk}: audio {tuple(a.shape)} finite; "
                  f"max|card - cpu| by mode "
                  + ", ".join(f"{n} {e[i].max():.2e}" for i, n in
                              enumerate(("ssb", "cw", "am", "nfm")))
                  + f"{' (cold start, not held)' if blk == 0 else ''}{vad}")
        print(f"[rx-options] {variant}: K1 launches {launches}")
    return total


def _loopback(mode: str, device) -> float:
    """tests/test_tx_chain.py's loopback on ``device``: the TX output of one
    channel fed into the RX of a fresh duplex tuned to it; returns the SNR
    of the demodulated audio against the reference audio."""
    n = 96 * 2048 // 4
    settle = 16 * 1024
    t = np.arange(n) / 48_000.0
    agc = AgcConfig(target=1e9, max_gain=1.0) if mode == "ssb" else AgcConfig()
    if mode == "ssb":
        audio, off = FX.voicelike_audio(48_000.0, n), 25_000.0
        bpf = FD.complex_bandpass_taps(513, 300.0, 2700.0, 48_000.0)
        ref = np.convolve(np.convolve(audio.astype(np.complex128), bpf)[:n], bpf)[:n]
        ref = 4.0 * np.real(ref)
    else:
        tone, off, amp = (600.0, -30_000.0, 0.6) if mode == "am" else (1000.0, 40_000.0, 0.5)
        audio = ref = (amp * np.sin(2 * np.pi * tone * t)).astype(np.float32)
    dpx = DuplexChain(RxConfig(channels=1, agc=agc),
                      TxConfig(channels=1, compressor_max_gain=1.0)).to(device)
    w = _dev(nco.freq_word([off], 192_000.0).astype(np.int32), device)
    m = torch.tensor([MODE_CODES[mode]], dtype=torch.int32, device=device)
    a = _dev(audio[None, :].astype(np.float32), device)
    with torch.no_grad():
        _, _, tx_iq, _ = dpx.step(dpx.init_state(), torch.zeros(
            (1, 4 * n), dtype=torch.complex64, device=device), a, w, m, w, m)
        _, out, _, _ = dpx.step(dpx.init_state(), tx_iq, torch.zeros_like(a), w, m, w, m)
    out = out[0].cpu().numpy()
    return audio_snr_db(np.asarray(ref)[settle:], out[settle:], trim=1024)


def phase_loopback(dev) -> None:
    """SSB, AM and NFM from the card's TxChain into its RxChain (one duplex
    each): SNR above LOOP_BARS and within SNR_TOL_DB of the same loopback on
    the CPU."""
    for mode, bar in LOOP_BARS.items():
        card, cpu = _loopback(mode, dev), _loopback(mode, "cpu")
        print(f"[loopback] {mode.upper()}: SNR card {card:.2f} dB, cpu {cpu:.2f} dB, delta "
              f"{card - cpu:+.3f} dB (bar {bar:.0f} dB)")
        check(card > bar, f"loopback {mode} SNR {card:.1f} dB")
        check(abs(card - cpu) <= SNR_TOL_DB, f"loopback {mode} SNR card vs cpu")


def phase_tx_time(dev, label: str) -> None:
    """CUDA-event medians of TxChain.step at tx_adc_r1280 (output IQ
    samples/s), DuplexChain.step at bench.py's duplex row (RX input
    samples/s) and the RX options step (each variant); each step's device
    busy share and activities per step from torch.profiler."""
    g = np.random.default_rng(SEED + 33)
    steps = {}
    tx = TxChain(tx_config()).to(dev)
    a = _dev(_tx_inputs(g, TX_C, 512, 1)[0], dev)
    tw = _dev(nco.freq_word(np.linspace(-20e6, 20e6, TX_C), 61.44e6), dev)
    tm = _dev((np.arange(TX_C) % 5).astype(np.int32), dev)
    tst = [tx.init_state()]

    def tx_step():
        tst[0], _ = tx.step(tst[0], a, tw, tm)

    steps["TxChain.step (tx_adc_r1280)"] = (tx_step, TX_C * 512 * 1280, "output IQ")
    both = {"TxChain.step (tx_adc_r1280)": (tx.step, tx.init_state(), (a, tw, tm))}
    iq, audio, rxw, rxm, txw, txm = _duplex_inputs(C_FLAG)
    dpx = DuplexChain(*duplex_configs()).to(dev)
    dargs = [_dev(v, dev) for v in (iq[1], audio[1], rxw, rxm, txw, txm)]
    dst = [dpx.init_state()]

    def duplex_step():
        dst[0], _, _, _ = dpx.step(dst[0], *dargs)

    steps["DuplexChain.step (duplex)"] = (duplex_step, C_FLAG * T_FLAG, "RX input")
    both["DuplexChain.step (duplex)"] = (dpx.step, dpx.init_state(), dargs)
    for variant in RX_OPTIONS:
        rx = RxChain(rx_options_config(variant)).to(dev)
        rst = [rx.init_state()]
        rargs = (dargs[0], dargs[2], dargs[3])

        def rx_step(rx=rx, rst=rst, rargs=rargs):
            rst[0], _, _ = rx.step(rst[0], *rargs)

        steps[f"RxChain.step (options {variant})"] = (rx_step, C_FLAG * T_FLAG, "RX input")
        both[f"RxChain.step (options {variant})"] = (rx.step, rx.init_state(), rargs)
    with torch.no_grad():
        for what, (fn, n, unit) in steps.items():
            ms = median_ms(fn, runs=7, inner=5)
            print(f"[time] {what}: {ms:.4f} ms/block, {n / (ms * 1e-3):.4g} {unit} samples/s "
                  f"({label})")
            profile_steps(fn, what, label, top=8)
    for what, (step, state, inputs) in both.items():
        host_both_ways(what, step, state, inputs, label)


# --- config 5: the wideband channelizer ---------------------------------------------------

CH_NAMES = ("ssb", "cw", "am", "nfm", "lsb")
# FP32 operations per element of the K4 back end, counted from the code
# (transcendentals as one): the demod value by mode, |X|^2 (3), the AM DC
# block run for every channel (4), the AGC (10) and power + waterfall (2)
MODE_OPS = {SSB: 1, LSB: 1, CW: 10, AM: 0, NFM: 8}


def _agc_cases():
    """(label, per-mode AGC profiles, apply_agc)."""
    attack = (AgcConfig(release_s=0.5, attack_s=0.002), AgcConfig(release_s=0.25, attack_s=0.001),
              AgcConfig(release_s=0.8, attack_s=0.005), AgcConfig(),
              AgcConfig(release_s=0.5, attack_s=0.002), AgcConfig(release_s=0.8, attack_s=0.005))
    return [("instant attack", (AgcConfig(),) * 6, True), ("nonzero attack", attack, True),
            ("demod only", (AgcConfig(),) * 6, False)]


def _consts(M: int, fs_ch: float, mode_cfgs, modes: np.ndarray, dev):
    """(mode, cw_word, rel, al, tgt, mg) per channel, as the chain gathers them."""
    mode = torch.from_numpy(modes.astype(np.int32)).to(dev)
    rel, al, tgt, mg = AgcBank(mode_cfgs, fs_ch).to(dev).per_channel(mode)
    word = torch.full((M,), int(nco.freq_word(600.0, fs_ch)), dtype=torch.int32, device=dev)
    return mode, word, rel, al, tgt, mg


def _wideband(rng, T: int, M: int, modes: np.ndarray) -> np.ndarray:
    """(2, T) float32 I/Q planes: unit Gaussian noise plus a carrier at the
    center of every NFM channel. An FM signal has a constant envelope; on
    noise alone the discriminator divides by |X| near 0, where float32
    rounding of the FFT is magnified without bound."""
    k = np.arange(M)
    comb = 0.5 * np.exp(2j * np.pi * np.outer(np.flatnonzero(modes == NFM), k) / M).sum(axis=0)
    x = rng.standard_normal((2, T)).astype(np.float32)
    c = np.tile(comb, T // M)
    return np.stack([x[0] + c.real, x[1] + c.imag]).astype(np.float32)


def _carry0(M: int, dev) -> torch.Tensor:
    st = torch.zeros((7, M), dtype=torch.float32, device=dev)
    st[2] = 1.0  # nfm_last starts at 1 + 0j, as demod.bank_init
    return st


def _audio_err(a_k, a_p, modes) -> np.ndarray:
    """|audio difference| (M, F), NFM rows modulo NFM_PERIOD."""
    return np.abs(_nfm_mod((a_k - a_p).T.cpu().numpy(), modes, NFM_PERIOD))


def _carry_err(st_k, st_p) -> float:
    """Largest carry difference, each row relative to its own scale (>= 1)."""
    scale = torch.clamp_min(st_p.abs().amax(dim=1), 1.0)
    return float(((st_k - st_p).abs().amax(dim=1) / scale).max())


def _wf_err_db(wf_k, wf_p) -> float:
    db = lambda w: 10.0 * torch.log10(torch.clamp_min(w, 1e-24))
    return float((db(wf_k) - db(wf_p)).abs().max())


def _by_mode(err: np.ndarray, modes: np.ndarray) -> str:
    return ", ".join(f"{n} {err[modes == k].max():.2e}" for k, n in enumerate(CH_NAMES)
                     if (modes == k).any())


def _print_occupancy(tag: str, what: str, occ: dict) -> None:
    """A launch's resources on the card (pfb_plan.occupancy)."""
    cl = (f"clusters of {occ['cluster']}, {occ['clusters']} resident on {occ['sms']} SMs"
          if occ["cluster"] else f"no cluster, {occ['sms']} SMs")
    print(f"[{tag}] {what}: {occ['registers']} registers a thread ({occ['local_bytes']} B "
          f"local), {occ['threads']} threads and {occ['smem']} B of shared memory a block, "
          f"{occ['blocks_per_sm']} resident a SM, {cl}")


def phase_ch_kernels(dev, blocks: int = 2) -> dict:
    """K3, K4 and K5 against their plain versions on the card, at config 5's
    shapes and at M=64 and 32. K4 is fed the plain K3's planes; each side carries
    its own state. Returns the largest held error per kernel."""
    rng = np.random.default_rng(SEED + 2)
    worst = {"pfb_dft": 0.0, "demod_agc": 0.0, "channelizer_one": 0.0}
    dev_i = torch.cuda.current_device()
    for what, occ in (("K3", pfb_plan.occupancy("pfb_dft", dev_i, 0, CH_M, CH_K)),
                      ("K5", pfb_plan.occupancy("channelizer_one", dev_i, CH_M))):
        _print_occupancy("ch-kernels", f"{what} M={CH_M}", occ)
    fs_ch = 15_000.0
    for M, T in ((CH_M, CH_T), (64, 64 * 128), (32, 32 * 128)):
        F = T // M
        modes = np.arange(M) % 5
        k3 = FusedPfbDft(M, CH_K).to(dev)
        tail = k3.init_state(1)
        blocks_in = []
        for blk in range(blocks):
            x = torch.from_numpy(_wideband(rng, T, M, modes)).to(dev)
            xr, xi = x[0], x[1]
            before = k3.launches
            (yr_k, yi_k), tail_next = k3.step_planes(tail, xr, xi)
            check(k3.launches == before + 1, "K3 launch counter")
            yr_p, yi_p = plain_pfb_dft(k3.h, tail, xr, xi)
            torch.cuda.synchronize()
            scale = float(torch.maximum(yr_p.abs().max(), yi_p.abs().max()))
            err = float(torch.maximum((yr_k - yr_p).abs().max(), (yi_k - yi_p).abs().max()))
            worst["pfb_dft"] = max(worst["pfb_dft"], err)
            check(err <= CH_PLANE_TOL * scale, f"K3 M={M} block {blk}: max|dy| {err:.3g} "
                                               f"(scale {scale:.3g})")
            print(f"[ch-kernels] K3 M={M} block {blk}: planes ({F}, {M}) max|dy| {err:.3e} "
                  f"(scale {scale:.3f}, {err / scale:.2e} of it)")
            blocks_in.append((tail, xr, xi, yr_p, yi_p))
            tail = tail_next
        for label, mode_cfgs, apply in _agc_cases():
            mode, word, rel, al, tgt, mg = _consts(M, fs_ch, mode_cfgs, modes, dev)
            kw = dict(wf_avg=16, enabled=(0, 1, 2, 3, 4), apply_agc=apply)
            k4 = FusedDemodAgc(M, fs_ch, 2500.0, **kw).to(dev)
            k5 = FusedChannelizerOne(M, CH_K, fs_ch, 2500.0, **kw).to(dev)
            st = {key: _carry0(M, dev) for key in ("4k", "4p", "5k", "5p")}
            acc = np.zeros(M, np.int64)
            for blk, (tl, xr, xi, yr, yi) in enumerate(blocks_in):
                cw_acc = torch.from_numpy(acc.astype(np.int32)).to(dev)
                consts = (mode, word, cw_acc, rel, al, tgt, mg)
                n4, n5 = k4.launches, k5.launches
                outs = {"4k": k4(yr, yi, *consts, st["4k"]),
                        "4p": plain_demod_agc(yr, yi, *consts, st["4p"], enabled=k4.en, fs=fs_ch,
                                              nfm_deviation_hz=2500.0, wf_avg=16,
                                              apply_agc=apply),
                        "5k": k5.call_planes(tl, xr, xi, *consts, st["5k"]),
                        "5p": plain_channelizer_one(k5, tl, xr, xi, *consts, st["5p"])}
                check(k4.launches == n4 + 1 and k5.launches == n5 + 1, "K4/K5 launch counters")
                torch.cuda.synchronize()
                for kern, name in (("4", "demod_agc"), ("5", "channelizer_one")):
                    (a_k, p_k, wf_k, s_k), (a_p, p_p, wf_p, s_p) = outs[kern + "k"], outs[kern + "p"]
                    check(a_k.shape == (F, M) and bool(torch.isfinite(a_k).all()),
                          f"K{kern} {label}: audio shape/finite")
                    # pre-gain audio (demod only) is not normalized: its bound is
                    # relative to its scale, like the carry rows'
                    aerr = _audio_err(a_k, a_p, modes)
                    if not apply:
                        aerr /= max(1.0, float(a_p.abs().max()))
                    wf_err = _wf_err_db(wf_k, wf_p)
                    c_err = _carry_err(s_k, s_p)
                    what = f"K{kern} M={M} {label} block {blk}"
                    if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
                        check(aerr.max() <= CH_TOL, f"{what}: audio {aerr.max():.3g}")
                        worst[name] = max(worst[name], float(aerr.max()))
                    check(wf_err <= WF_TOL_DB, f"{what}: waterfall {wf_err:.3g} dB")
                    check(c_err <= CH_TOL, f"{what}: carry {c_err:.3g}")
                    plan = (k5 if kern == "5" else k4).last_plan
                    print(f"[ch-kernels] {what}: walk S={plan.segments} L={plan.length}; "
                          f"audio max|d| by mode {_by_mode(aerr, modes)}"
                          f"{' (relative to its scale)' if not apply else ''}"
                          f"{' (cold start, not held)' if blk == 0 else ''}; waterfall "
                          f"{wf_err:.2e} dB; carry {c_err:.2e} (relative)")
                st = {key: outs[key][3] for key in st}
                acc = (acc + int(word[0]) * F + 2 ** 31) % 2 ** 32 - 2 ** 31
    return worst


# config 5 without AM (the emit_env tier's population): SSB, CW, LSB, NFM, the
# NFM channels those of arange(M) % 4
EMIT_MODES = np.array([SSB, CW, LSB, NFM])[np.arange(CH_M) % 4]


def _k5_blocks(dev, rng, k5: FusedChannelizerOne, T: int, modes: np.ndarray, tag: str,
               what: str, blocks: int = 2, mode_cfgs=(AgcConfig(),) * 6) -> float:
    """K5 against its plain version on ``blocks`` blocks of T wideband
    samples, carry rows chained from the cold start (row 4 from zero), its
    walk in ``k5.walk_segments`` segments (None: walk_plan's default). Built
    demod-only (``apply_agc`` off, with or without ``emit_env``): audio, and
    env under emit_env, within CH_TOL of scale; with the AGC applied: audio
    within CH_TOL after block 0 (the cold-start transient amplifies ulps).
    The carry within CH_TOL, the waterfall within WF_TOL_DB. Returns the
    largest error held."""
    M, F = k5.M, T // k5.M
    mode, word, rel, al, tgt, mg = _consts(M, k5.fs, mode_cfgs, modes, dev)
    tail = k5.init_tail()
    st_k, st_p = _carry0(M, dev), _carry0(M, dev)
    acc, worst = np.zeros(M, np.int64), 0.0
    for blk in range(blocks):
        x = torch.from_numpy(_wideband(rng, T, M, modes)).to(dev)
        consts = (mode, word, torch.from_numpy(acc.astype(np.int32)).to(dev), rel, al, tgt, mg)
        before = k5.launches
        out_k = k5.call_planes(tail, x[0], x[1], *consts, st_k)
        check(k5.launches == before + 1, f"{what}: launch counter")
        out_p = plain_channelizer_one(k5, tail, x[0], x[1], *consts, st_p)
        torch.cuda.synchronize()
        (a_k, _, wf_k, s_k), (a_p, _, wf_p, s_p) = out_k[:4], out_p[:4]
        check(a_k.shape == (F, M) and bool(torch.isfinite(a_k).all()),
              f"{what}: audio shape/finite")
        aerr = float(_audio_err(a_k, a_p, modes).max())
        errs = {"audio": aerr if k5.apply_agc else aerr / max(1.0, float(a_p.abs().max()))}
        if k5.apply_agc and blk == 0:  # cold start: not held
            errs = {}
        if k5.emit_env:
            e_k, e_p = out_k[4], out_p[4]
            check(len(out_k) == 5 and e_k.shape == (F, M) and bool(torch.isfinite(e_k).all()),
                  f"{what}: env shape/finite")
            errs["env"] = float((e_k - e_p).abs().max()) / max(1.0, float(e_p.abs().max()))
            check(torch.equal(s_k[4], e_k[-1]) and torch.equal(s_k[5], st_k[5]),
                  f"{what} block {blk}: carry row 4 is the last env, row 5 untouched")
        c_err, wf_err = _carry_err(s_k, s_p), _wf_err_db(wf_k, wf_p)
        for k, e in errs.items():
            check(e <= CH_TOL, f"{what} block {blk}: {k} {e:.3g}")
        check(c_err <= CH_TOL, f"{what} block {blk}: carry {c_err:.3g}")
        check(wf_err <= WF_TOL_DB, f"{what} block {blk}: waterfall {wf_err:.3g} dB")
        worst = max([worst, *errs.values()])
        plan = k5.last_plan
        held = ", ".join(f"{k} max|d| {e:.2e}" for k, e in errs.items()) or "audio not held"
        print(f"[{tag}] {what} block {blk}: walk S={plan.segments} L={plan.length}; {held}"
              f"{'' if k5.apply_agc else ' (of scale)'}; carry {c_err:.2e} (relative); "
              f"waterfall {wf_err:.2e} dB")
        st_k, st_p = s_k, s_p
        tail = torch.complex(x[0, -(k5.K - 1) * M:], x[1, -(k5.K - 1) * M:])[None]
        acc = (acc + int(word[0]) * F + 2 ** 31) % 2 ** 32 - 2 ** 31
    return worst


def _emit_env_k5() -> FusedChannelizerOne:
    return FusedChannelizerOne(CH_M, CH_K, 15_000.0, 2500.0, wf_avg=16, enabled=(SSB, CW, NFM, LSB),
                               apply_agc=False, emit_env=True)


def phase_emit_env_kernel(dev) -> float:
    """K5's emit_env variant against its plain version at config 5's shapes;
    returns the largest error held, relative to each output's scale."""
    return _k5_blocks(dev, np.random.default_rng(SEED + 10), _emit_env_k5().to(dev), CH_T,
                      EMIT_MODES, "emit-env", f"K5 emit_env M={CH_M}")


def phase_shard_shapes(dev) -> dict:
    """Each kernel the sharded channelizer launches (sharded-channelizer,
    phase 6d), against its plain version at the shapes that path gives it on
    a (1, 4) mesh: K3 on the one lookback frame (F=1, the single-pass forms'
    frame -1) and on a rank's slice (F_local=512, strided planes of a complex
    block, as ``call_planes`` takes them); K4 at M/D=1024 channels over the
    block's F=2048 frames (the two-kernel form after the all_to_all; rank 1's
    channels of K3's planes, instant attack, two blocks); K5 demod-only over
    all five modes ("xla" tier) and K5's emit_env variant ("emit_env" tier),
    at F_local=512, two blocks each. Returns the largest error held per
    kernel."""
    rng = np.random.default_rng(SEED + 12)
    worst = {}
    T_loc, Ml = CH_T // SHARD_RANKS, CH_M // SHARD_RANKS
    k3 = FusedPfbDft(CH_M, CH_K).to(dev)
    modes = np.arange(CH_M) % 4
    for label, T in (("frame -1", CH_M), ("F_local", T_loc)):
        tail_x = _wideband(rng, (CH_K - 1) * CH_M, CH_M, modes)
        tail = torch.from_numpy(tail_x[0] + 1j * tail_x[1]).to(dev, torch.complex64)[None]
        x_np = _wideband(rng, T, CH_M, modes)
        x = torch.from_numpy(x_np[0] + 1j * x_np[1]).to(dev, torch.complex64)[None]
        before = k3.launches
        (yr_k, yi_k), _ = k3.call_planes(tail, x)
        check(k3.launches == before + 1, "K3 launch counter")
        yr_p, yi_p = plain_pfb_dft(k3.h, tail, x[0].real.contiguous(), x[0].imag.contiguous())
        torch.cuda.synchronize()
        scale = float(torch.maximum(yr_p.abs().max(), yi_p.abs().max()))
        err = float(torch.maximum((yr_k - yr_p).abs().max(), (yi_k - yi_p).abs().max()))
        check(yr_k.shape == (T // CH_M, CH_M), f"K3 {label}: planes {tuple(yr_k.shape)}")
        check(err <= CH_PLANE_TOL * scale, f"K3 {label}: max|dy| {err:.3g} (scale {scale:.3g})")
        worst["pfb_dft"] = max(worst.get("pfb_dft", 0.0), err)
        print(f"[shard-shapes] K3 {label}: planes {tuple(yr_k.shape)} max|dy| {err:.3e} "
              f"({err / scale:.2e} of scale)")
    # K4 on one rank's 1024 channels of whole-block planes
    F = CH_T // CH_M
    cfg = presets.channelizer_61m44(CH_M)
    sl = slice(Ml, 2 * Ml)
    k4 = FusedDemodAgc(Ml, cfg.fs_channel, cfg.nfm_deviation_hz, wf_avg=cfg.waterfall_frame_avg,
                       enabled=cfg.enabled_modes).to(dev)
    mode, word, rel, al, tgt, mg = _consts(Ml, cfg.fs_channel, (cfg.agc,) * 6, modes[sl], dev)
    st_k, st_p = _carry0(Ml, dev), _carry0(Ml, dev)
    acc, tail = np.zeros(Ml, np.int64), k3.init_state(1)
    worst["demod_agc"] = 0.0
    for blk in range(2):
        x = torch.from_numpy(_wideband(rng, CH_T, CH_M, modes)).to(dev)
        yr, yi = plain_pfb_dft(k3.h, tail, x[0], x[1])
        yr, yi = yr[:, sl].contiguous(), yi[:, sl].contiguous()
        consts = (mode, word, torch.from_numpy(acc.astype(np.int32)).to(dev), rel, al, tgt, mg)
        before = k4.launches
        a_k, _, wf_k, s_k = k4(yr, yi, *consts, st_k)
        check(k4.launches == before + 1, "K4 launch counter")
        a_p, _, wf_p, s_p = plain_demod_agc(yr, yi, *consts, st_p, enabled=k4.en, fs=k4.fs,
                                            nfm_deviation_hz=k4.nfm_deviation_hz,
                                            wf_avg=k4.wf_avg, apply_agc=True)
        torch.cuda.synchronize()
        check(a_k.shape == (F, Ml) and bool(torch.isfinite(a_k).all()), "K4 M/D: audio shape")
        aerr = float(_audio_err(a_k, a_p, modes[sl]).max())
        c_err, wf_err = _carry_err(s_k, s_p), _wf_err_db(wf_k, wf_p)
        what = f"K4 M/D={Ml} F={F} block {blk}"
        if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
            check(aerr <= CH_TOL, f"{what}: audio {aerr:.3g}")
            worst["demod_agc"] = max(worst["demod_agc"], aerr)
        check(c_err <= CH_TOL, f"{what}: carry {c_err:.3g}")
        check(wf_err <= WF_TOL_DB, f"{what}: waterfall {wf_err:.3g} dB")
        print(f"[shard-shapes] {what}: walk S={k4.last_plan.segments} L={k4.last_plan.length}; "
              f"audio max|d| {aerr:.2e}"
              f"{' (cold start, not held)' if blk == 0 else ''}; carry {c_err:.2e} "
              f"(relative); waterfall {wf_err:.2e} dB")
        st_k, st_p = s_k, s_p
        tail = torch.complex(x[0, -(CH_K - 1) * CH_M:], x[1, -(CH_K - 1) * CH_M:])[None]
        acc = (acc + int(word[0]) * F + 2 ** 31) % 2 ** 32 - 2 ** 31
    xla = FusedChannelizerOne(CH_M, CH_K, 15_000.0, 2500.0, wf_avg=16, enabled=(0, 1, 2, 3, 4),
                              apply_agc=False).to(dev)
    F_loc = T_loc // CH_M
    worst["channelizer_one"] = _k5_blocks(dev, rng, xla, T_loc, np.arange(CH_M) % 5,
                                          "shard-shapes", f"K5 demod only F={F_loc}")
    worst["channelizer_one_emit_env"] = _k5_blocks(
        dev, rng, _emit_env_k5().to(dev), T_loc, EMIT_MODES, "shard-shapes",
        f"K5 emit_env F={F_loc}")
    return worst


def phase_walk_joins(dev) -> dict:
    """The segmented walk at its joins, each case against its plain version
    over two chained blocks with nonzero attack (all five modes): K5 at
    M=4096, F=2048 with S=3 (L=688, a ragged last segment of 672 frames);
    K5 at the smallest F it takes, one waterfall line (F=16: one segment);
    K5 at M=64, F=128 with one line per segment (S=8, L=16); K6 at C=128,
    Ta=4096 with S=3 (L=1366, last 1364) and S=256 (L=16). Returns the
    largest error held per kernel."""
    rng = np.random.default_rng(SEED + 14)
    attack = _agc_cases()[1][1]
    worst = {"channelizer_one": 0.0}
    for M, T, S, want in ((CH_M, CH_T, 3, "ragged"), (CH_M, 16 * CH_M, None, "one segment"),
                          (64, 128 * 64, 8, "one line a segment")):
        k5 = FusedChannelizerOne(M, CH_K, 15_000.0, 2500.0, wf_avg=16,
                                 enabled=(0, 1, 2, 3, 4)).to(dev)
        k5.walk_segments = S
        e = _k5_blocks(dev, rng, k5, T, np.arange(M) % 5, "walk-joins",
                       f"K5 M={M} F={T // M} nonzero attack", mode_cfgs=attack)
        S_, L = k5.last_plan.segments, k5.last_plan.length
        check({"ragged": S_ == S and (T // M) % L != 0, "one segment": S_ == 1,
               "one line a segment": S_ == S and L == 16}[want], f"K5 M={M}: {want}, S={S_} L={L}")
        worst["channelizer_one"] = max(worst["channelizer_one"], e)
    worst["ols_demod"] = max(_k6_blocks(dev, rng, C_FLAG, f"nonzero attack S={S}", attack,
                                        segments=S, tag="walk-joins") for S in (3, 256))
    worst["demod_agc"] = 0.0
    for M, S, want in ((CH_M, 3, "ragged"), (CH_M // SHARD_RANKS, None, "plan")):
        for apply in (True, False):
            k4 = FusedDemodAgc(M, 15_000.0, 2500.0, wf_avg=16, enabled=(0, 1, 2, 3, 4),
                               apply_agc=apply).to(dev)
            k4.walk_segments = S
            e = _k4_blocks(dev, rng, k4, CH_T // CH_M, np.arange(M) % 5, attack,
                           f"K4 M={M} F={CH_T // CH_M} nonzero attack"
                           f"{'' if apply else ' demod only'}")
            S_, L = k4.last_plan.segments, k4.last_plan.length
            check(S_ > 1 and (want != "ragged" or (S_ == S and (CH_T // CH_M) % L != 0)),
                  f"K4 M={M}: {want}, S={S_} L={L}")
            worst["demod_agc"] = max(worst["demod_agc"], e)
    return worst


# the hang route's AGC profiles: the kernels run demod-only, the AgcBank after them
HANG_AGC = (AgcConfig(release_s=0.5, attack_s=0.002, hang_s=0.01),
            AgcConfig(release_s=0.25, hang_s=0.005),
            AgcConfig(release_s=0.8, attack_s=0.005, hang_s=0.02), AgcConfig(),
            AgcConfig(release_s=0.5, attack_s=0.002, hang_s=0.01),
            AgcConfig(release_s=0.8, hang_s=0.02))


def _k5_layouts(dev, rng, k5: FusedChannelizerOne, T: int, modes: np.ndarray, mode_cfgs,
                what: str, blocks: int = 2) -> None:
    """K5 asked for channel-major audio against K5 asked for frame-major on
    the same ``blocks`` chained blocks, its walk in ``k5.walk_segments``
    segments: contiguous (M, F) audio bit-equal to the frame-major audio
    transposed, power, waterfall and carry bit-equal, the same walk plan, and
    each launch counted under its layout."""
    M, F = k5.M, T // k5.M
    mode, word, rel, al, tgt, mg = _consts(M, k5.fs, mode_cfgs, modes, dev)
    tail, st = k5.init_tail(), _carry0(M, dev)
    acc = np.zeros(M, np.int64)
    for blk in range(blocks):
        x = torch.from_numpy(_wideband(rng, T, M, modes)).to(dev)
        consts = (mode, word, torch.from_numpy(acc.astype(np.int32)).to(dev), rel, al, tgt, mg)
        before = dict(k5.variant_launches)
        fm = k5.call_planes(tail, x[0], x[1], *consts, st)
        plan = k5.last_plan
        cm = k5.call_planes(tail, x[0], x[1], *consts, st, channel_major=True)
        torch.cuda.synchronize()
        check(k5.variant_launches == {k: n + 1 for k, n in before.items()},
              f"{what}: a launch of each layout counted, {k5.variant_launches}")
        check(k5.last_plan == plan, f"{what}: walk plans {plan} and {k5.last_plan} differ")
        check(cm[0].shape == (M, F) and cm[0].is_contiguous(), f"{what}: audio {cm[0].shape}")
        same = [torch.equal(cm[0], fm[0].T)] + [torch.equal(a, b) for a, b in zip(cm[1:], fm[1:])]
        check(all(same), f"{what} block {blk}: channel-major against frame-major transposed: "
                         f"audio, power, waterfall, carry equal {same}")
        print(f"[channel-major] {what} block {blk}: walk S={plan.segments} L={plan.length} "
              f"(L % 32 = {plan.length % 32}); audio (M, F) bit-equal to (F, M) transposed, "
              f"power, waterfall and carry bit-equal")
        st = fm[3]
        tail = torch.complex(x[0, -(k5.K - 1) * M:], x[1, -(k5.K - 1) * M:])[None]
        acc = (acc + int(word[0]) * F + 2 ** 31) % 2 ** 32 - 2 ** 31


def _chain_layouts(dev, rng, cfg, what: str, blocks: int = 3) -> None:
    """ChannelizerChain through K5 (channel-major audio, no transposed copy)
    against the same chain with K5 asked for frame-major and its audio
    transposed after it, as the single-pass chain ran before: audio, aux and
    state bit-equal over ``blocks`` chained blocks."""
    chain, twin = ChannelizerChain(cfg).to(dev), ChannelizerChain(cfg).to(dev)
    launch = twin.one_kernel.call_planes

    def frame_major(*args, channel_major=False):
        out = launch(*args)
        return (out[0].T.contiguous(),) + out[1:] if channel_major else out

    twin.one_kernel.call_planes = frame_major
    M = cfg.num_channels
    modes = np.arange(M) % 4
    mode = torch.from_numpy(modes.astype(np.int32)).to(dev)
    st_c, st_t = chain.init_state(), twin.init_state()
    with torch.no_grad():
        for blk in range(blocks):
            x = torch.from_numpy(_wideband(rng, CH_T, M, modes)).to(dev)
            st_c, a_c, aux_c = chain.step_planes(st_c, x[0], x[1], mode)
            st_t, a_t, aux_t = twin.step_planes(st_t, x[0], x[1], mode)
            torch.cuda.synchronize()
            same = (torch.equal(a_c, a_t), _tree_equal(aux_c, aux_t), _tree_equal(st_c, st_t))
            check(all(same), f"{what} block {blk}: audio, aux, state equal {same}")
    k = chain.one_kernel
    check(k.variant_launches["channel_major"] == blocks and k.variant_launches["frame_major"] == 0,
          f"{what}: K5 launches by layout {k.variant_launches}")
    print(f"[channel-major] {what}: {blocks} blocks, audio {tuple(a_c.shape)}, aux and state "
          f"bit-equal to K5 frame-major + transposed copy; hang route {chain.agc_in_torch}")


def phase_channel_major(dev) -> None:
    """K5's channel-major audio (the single-pass chain's) against its
    frame-major audio transposed, bit for bit: at config 5's M=4096, F=2048
    with the plan's S under each AGC case (demod only is the hang route's
    kernel), at S=3 (L=688: each segment ends on a part-filled tile) and S=1,
    at M=64 (tiles of one warp) and M=16 (below a warp: direct stores); then
    the single-pass chain, with the AGC and on the hang route, against the
    chain with K5 frame-major and the transposed copy after it."""
    rng = np.random.default_rng(SEED + 16)
    for label, mode_cfgs, apply in _agc_cases():
        k5 = FusedChannelizerOne(CH_M, CH_K, 15_000.0, 2500.0, wf_avg=16,
                                 enabled=(0, 1, 2, 3, 4), apply_agc=apply).to(dev)
        _k5_layouts(dev, rng, k5, CH_T, np.arange(CH_M) % 5, mode_cfgs, f"K5 M={CH_M} {label}")
    attack = _agc_cases()[1][1]
    for M, T, S in ((CH_M, CH_T, 3), (CH_M, CH_T, 1), (64, 64 * 128, None), (16, 16 * 128, None)):
        k5 = FusedChannelizerOne(M, CH_K, 15_000.0, 2500.0, wf_avg=16,
                                 enabled=(0, 1, 2, 3, 4)).to(dev)
        k5.walk_segments = S
        _k5_layouts(dev, rng, k5, T, np.arange(M) % 5, attack,
                    f"K5 M={M} F={T // M} S={S or 'plan'} nonzero attack")
    cfg = presets.channelizer_61m44(CH_M)
    _chain_layouts(dev, rng, cfg, "single-pass chain")
    hang = dataclasses.replace(cfg, agc_modes=HANG_AGC)
    _chain_layouts(dev, rng, hang, "single-pass chain, hang route")


def _k4_blocks(dev, rng, k4: FusedDemodAgc, F: int, modes: np.ndarray, mode_cfgs, what: str,
               blocks: int = 2) -> float:
    """K4 against plain_demod_agc on ``blocks`` blocks of (F, M) planes
    (unit Gaussian noise, a carrier in every NFM channel), carry rows
    chained from the cold start, its walk in ``k4.walk_segments`` segments.
    Audio within CH_TOL after block 0 with the AGC applied, of its scale
    without; carry within CH_TOL, waterfall within WF_TOL_DB. Returns the
    largest audio error held."""
    M = k4.M
    mode, word, rel, al, tgt, mg = _consts(M, k4.fs, mode_cfgs, modes, dev)
    st_k, st_p = _carry0(M, dev), _carry0(M, dev)
    acc, worst = np.zeros(M, np.int64), 0.0
    nfm = torch.from_numpy(modes == NFM).to(dev)
    for blk in range(blocks):
        x = torch.from_numpy(rng.standard_normal((2, F, M)).astype(np.float32)).to(dev)
        yr, yi = x[0] + 2.0 * nfm, x[1]
        consts = (mode, word, torch.from_numpy(acc.astype(np.int32)).to(dev), rel, al, tgt, mg)
        before = k4.launches
        a_k, _, wf_k, s_k = k4(yr, yi, *consts, st_k)
        check(k4.launches == before + 1, f"{what}: launch counter")
        a_p, _, wf_p, s_p = plain_demod_agc(yr, yi, *consts, st_p, enabled=k4.en, fs=k4.fs,
                                            nfm_deviation_hz=k4.nfm_deviation_hz,
                                            wf_avg=k4.wf_avg, apply_agc=k4.apply_agc)
        torch.cuda.synchronize()
        check(a_k.shape == (F, M) and bool(torch.isfinite(a_k).all()),
              f"{what}: audio shape/finite")
        aerr = float(_audio_err(a_k, a_p, modes).max())
        if not k4.apply_agc:
            aerr /= max(1.0, float(a_p.abs().max()))
        held = blk > 0 or not k4.apply_agc  # block 0: cold-start AGC transient amplifies ulps
        if held:
            check(aerr <= CH_TOL, f"{what} block {blk}: audio {aerr:.3g}")
            worst = max(worst, aerr)
        c_err, wf_err = _carry_err(s_k, s_p), _wf_err_db(wf_k, wf_p)
        check(c_err <= CH_TOL, f"{what} block {blk}: carry {c_err:.3g}")
        check(wf_err <= WF_TOL_DB, f"{what} block {blk}: waterfall {wf_err:.3g} dB")
        plan = k4.last_plan
        print(f"[walk-joins] {what} block {blk}: walk S={plan.segments} L={plan.length}; audio "
              f"max|d| {aerr:.2e}{'' if k4.apply_agc else ' (of scale)'}"
              f"{'' if held else ' (cold start, not held)'}; carry {c_err:.2e} (relative); "
              f"waterfall {wf_err:.2e} dB")
        st_k, st_p = s_k, s_p
        acc = (acc + int(word[0]) * F + 2 ** 31) % 2 ** 32 - 2 ** 31
    return worst


def _plain_twin(cfg, dev) -> ChannelizerChain:
    """The same single-pass chain with K5 replaced by its plain version."""
    twin = ChannelizerChain(cfg).to(dev)
    twin.one_kernel.call_planes = functools.partial(plain_channelizer_one, twin.one_kernel)
    return twin


def _dense_config(cfg):
    return dataclasses.replace(cfg, fuse_pfb=False, fuse_demod=False, fuse_single_pass=False)


def phase_ch_slice(dev, blocks: int = 4) -> dict:
    """Monitor on the config-5 preset through K5 for 4 blocks, held against
    the plain-version chain; then the two-kernel Monitor (K3 -> K4), and the
    dense chain reported beside both. Returns each kernel's launches in the
    run of its own path."""
    cfg = presets.channelizer_61m44(CH_M)
    modes = np.arange(CH_M) % 4
    mon = Monitor(cfg, device=dev)
    two = Monitor(dataclasses.replace(cfg, fuse_single_pass=False), device=dev)
    for m in (mon, two):
        for c in range(CH_M):
            m.set_mode(c, CH_NAMES[modes[c]])
    rng = np.random.default_rng(SEED + 3)
    wide = []
    for _ in range(blocks):
        x = _wideband(rng, CH_T, CH_M, modes)
        wide.append((x[0] + 1j * x[1]).astype(np.complex64))
    k5 = mon.chain.one_kernel
    k5.launches = 0
    k5.variant_launches = dict.fromkeys(K5_MOD.LAYOUTS, 0)
    audio = [mon.process(x) for x in wide]
    launches = {"channelizer_one": k5.launches}
    _check_replayed("ch-slice", mon._compiled, blocks, {"K5": k5.launches})
    check(k5.variant_launches == {"frame_major": 0, "channel_major": k5.launches},
          f"ch-slice: every K5 launch of Monitor's step channel-major, {k5.variant_launches}")
    k3, k4 = two.chain.pfb, two.chain.demod_kernel
    k3.launches = k4.launches = 0
    k3.variant_launches = dict.fromkeys(PFB_VARIANTS, 0)
    audio_two = [two.process(x) for x in wide]
    launches.update(pfb_dft=k3.launches, demod_agc=k4.launches,
                    pfb_dft_variants=k3.variant_launches["base_b3"])
    _check_replayed("ch-slice two-kernel", two._compiled, blocks,
                    {"K3": k3.launches, "K4": k4.launches})
    check(mon.chain.one_kernel.launches == blocks + mon._compiled.signatures,
          "the single-pass Monitor launched K5 only")
    twin, dense = _plain_twin(cfg, dev), ChannelizerChain(_dense_config(cfg)).to(dev)
    st_p, st_d = twin.init_state(), dense.init_state()
    mode_t = torch.from_numpy(modes.astype(np.int32)).to(dev)
    for blk, (x, a, a2) in enumerate(zip(wide, audio, audio_two)):
        wr = torch.from_numpy(np.ascontiguousarray(x.real)).to(dev)
        wi = torch.from_numpy(np.ascontiguousarray(x.imag)).to(dev)
        with torch.no_grad():
            st_p, a_p, aux_p = twin.step_planes(st_p, wr, wi, mode_t)
            st_d, a_d, _ = dense.step(st_d, torch.complex(wr, wi), mode_t)
        check(a.shape == (CH_M, CH_T // CH_M) and bool(np.isfinite(a).all()),
              f"block {blk}: audio shape {a.shape} / finite")
        err = np.abs(_nfm_mod(a - a_p.cpu().numpy(), modes, NFM_PERIOD))
        d_two = np.abs(_nfm_mod(a - a2, modes, NFM_PERIOD))
        d_dense = np.abs(_nfm_mod(a - a_d.cpu().numpy(), modes, NFM_PERIOD))
        if blk > 0:
            check(err.max() <= CH_TOL, f"block {blk}: K5 chain vs plain chain {err.max():.3g}")
        print(f"[ch-slice] block {blk}: audio {a.shape} finite; max|K5 chain - plain chain| "
              f"{err.max():.3e}{' (cold start, not held)' if blk == 0 else ''}; "
              f"vs two-kernel: {_by_mode(d_two, modes)}; vs dense: {_by_mode(d_dense, modes)}")
    wf_err = float(np.abs(mon.waterfall() - aux_p["waterfall"].cpu().numpy()).max())
    cp_rel = float(np.abs(mon.channel_power() / aux_p["channel_power"].cpu().numpy() - 1).max())
    check(wf_err <= WF_TOL_DB, f"waterfall vs plain chain {wf_err:.3g} dB")
    print(f"[ch-slice] last block: waterfall {mon.waterfall().shape} max|d| {wf_err:.2e} dB, "
          f"channel_power rel {cp_rel:.2e}; launches in the main path: {launches}")
    return launches


# --- K9: K3's stage variants ------------------------------------------------------------------

K9_TOL = {"base_b3": CH_PLANE_TOL, "dft_only": CH_PLANE_TOL, "batched_b3": CH_PLANE_TOL,
          "pfb_only": 1e-5, "pfb_noshift": 1e-5}  # of each output's scale


def _k9_work(M: int, K: int, F: int) -> dict:
    """(bytes, FP32 operations) each K9 variant must at least move and do:
    planes in and out (8 B per sample each way), plus the taps and the tail
    where the variant reads them; 4 flops per polyphase tap, 5 M log2 M per
    FFT, 8 per complex multiply-add of the explicit CT product (M1 + M2 per
    output) and 6 per twiddle."""
    T = F * M
    M1, M2 = M // 128, 128
    taps = 4 * K * M + 8 * (K - 1) * M
    fft = 5 * F * M * np.log2(M)
    return {"base_b3": (16 * T + taps, 4 * K * T + fft),
            "pfb_only": (16 * T + taps, 4 * K * T),
            "pfb_noshift": (16 * T + 4 * K * M, 4 * K * T),
            "dft_only": (16 * T, fft),
            "batched_b3": (16 * T + taps + 8 * (M1 * M1 + M2 * M1 + M2 * M2),
                           4 * K * T + 8 * T * (M1 + M2) + 6 * T)}


def _batched_tf32_bound(M: int, K: int, F: int) -> float:
    """batched_b3's least time on the tensor cores (ms): its two products
    (8 flops a complex multiply-add, M1 + M2 per output) three times over at
    the dense TF32 peak, the polyphase and the twiddle at FP32's, the bytes
    at the memory rate; the larger of bytes and operations."""
    T = F * M
    M1, M2 = M // 128, 128
    nbytes, _ = _k9_work(M, K, F)["batched_b3"]
    t_ops = 3 * 8 * T * (M1 + M2) / TF32_OPS_PER_S + (4 * K * T + 6 * T) / FP32_OPS_PER_S
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, t_ops)


def _sass_count(lib: Path, kernel: str, opcode: str) -> dict:
    """{function: count of ``opcode``} over the functions of ``lib``'s SASS
    (cuobjdump -sass) whose names hold ``kernel``."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            current = name if kernel in name else None
            if current:
                counts[current] = 0
        elif current and opcode in line:
            counts[current] += 1
    return counts


def phase_k9(dev, label: str) -> tuple[float, dict]:
    """K9's five variants against their plain versions at K9's shapes (M=4096,
    K=8, F=2048) with a random tail, base_b3 bit-equal to K3; each variant's
    time, its plain version's and its bound. Returns the largest error
    relative to each output's scale, and the kernel-line row."""
    rng = np.random.default_rng(SEED + 9)
    k3 = FusedPfbDft(CH_M, CH_K).to(dev)
    x = torch.from_numpy(_wideband(rng, CH_T, CH_M, np.arange(CH_M) % 5)).to(dev)
    xr, xi = x[0], x[1]
    t = torch.from_numpy(rng.standard_normal((2, 1, (CH_K - 1) * CH_M)).astype(np.float32))
    tail = torch.complex(t[0], t[1]).to(dev)
    (yr3, yi3), _ = k3.step_planes(tail, xr, xi)  # K3 as the channelizer calls it
    worst = 0.0
    for v in PFB_VARIANTS:
        before = k3.variant_launches[v]
        (yr, yi), _ = k3.step_planes(tail, xr, xi, variant=v)
        check(k3.variant_launches[v] == before + 1, f"K9 {v}: launch counter")
        pr, pi = plain_variant(k3.h, k3.ct, tail, xr, xi, v)
        torch.cuda.synchronize()
        scale = max(1.0, float(torch.maximum(pr.abs().max(), pi.abs().max())))
        err = float(torch.maximum((yr - pr).abs().max(), (yi - pi).abs().max())) / scale
        worst = max(worst, err)
        check(err <= K9_TOL[v], f"K9 {v}: max|y_k - y_plain| {err:.3g} of scale {scale:.3g}")
        same = bool(torch.equal(yr, yr3) and torch.equal(yi, yi3))
        if v == "base_b3":
            check(same, "K9 base_b3 is not bit-equal to K3")
        print(f"[k9] {v}: planes {tuple(yr.shape)} max|err| {err:.3e} of scale {scale:.3f}"
              f"{'; bit-equal to K3' if same else ''}")
    dev_i = torch.cuda.current_device()
    for v in ("base_b3", "pfb_only", "pfb_noshift", "batched_b3"):
        _print_occupancy("k9", v, pfb_plan.occupancy("pfb_dft", dev_i, PFB_VARIANTS.index(v),
                                                     CH_M, CH_K))
        plan = k3.plan(v, CH_T // CH_M, dev_i)
        if plan is not None:
            print(f"[k9] {v}: {plan.runs} runs of {plan.run_length} frames, {plan.grid} blocks; "
                  f"input read {pfb_plan.bytes_read(plan) / (8 * CH_T):.3f} times")
    hmma = _sass_count(_build.build("pfb_dft").path, "pfb_batched_kernel", "HMMA")
    print(f"[k9] batched_b3's SASS (cuobjdump -sass): HMMA instructions by instantiation {hmma}")
    check(all(n > 0 for n in hmma.values()) and len(hmma) == 3,
          "batched_b3's kernel holds no tensor-core HMMA")
    ms, plain, bounds = {}, {}, {}
    with torch.no_grad():
        for v in PFB_VARIANTS:
            ms[v] = median_ms(lambda v=v: k3._launch(tail, xr, xi, v))
            plain[v] = median_ms(lambda v=v: plain_variant(k3.h, k3.ct, tail, xr, xi, v))
        planes = torch.complex(xr, xi).reshape(-1, CH_M)
        fft_ms = median_ms(lambda: torch.fft.fft(planes, dim=-1))
    for v, (nbytes, ops) in _k9_work(CH_M, CH_K, CH_T // CH_M).items():
        bounds[v] = bound(nbytes, ops)
        print(f"[time] K9 {v}: {ms[v]:.4f} ms/block (plain {plain[v]:.4f}); bound "
              f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP -> {bounds[v][0]:.4f} ms "
              f"({bounds[v][1]}), kernel at {bounds[v][0] / ms[v]:.1%} of it ({label})")
    nbytes, ops = _k9_work(CH_M, CH_K, CH_T // CH_M)["batched_b3"]
    tf32_ms = _batched_tf32_bound(CH_M, CH_K, CH_T // CH_M)
    print(f"[time] K9 batched_b3 against the tensor cores: its products 3xTF32 at the dense "
          f"TF32 peak / 3 ({TF32_OPS_PER_S / 3e12:.0f} TFLOP/s), the rest FP32: bound "
          f"{tf32_ms:.4f} ms; kernel at {tf32_ms / ms['batched_b3']:.1%} of it ({label})")
    print(f"[time] K9 dft_only's library call, torch.fft.fft of the raw frames: {fft_ms:.4f} ms "
          f"({label})")
    fft = _fft_yardsticks(dev, rng, label)
    row = {"ms": ms["base_b3"], "plain_ms": plain["base_b3"], "bound_ms": bounds["base_b3"][0],
           "bound_by": bounds["base_b3"][1], "library_ms": None, "variants_ms": ms,
           "variants_plain_ms": plain, "variants_bound_ms": {v: b[0] for v, b in bounds.items()},
           "variants_library_ms": {"dft_only": fft_ms}, "fft": fft,
           "batched_b3_tf32_bound_ms": tf32_ms, "batched_b3_hmma": sum(hmma.values())}
    return max(worst, max(f["err"] for f in fft.values())), row


def _fft_yardsticks(dev, rng, label: str) -> dict:
    """rf::fft alone (K9's dft_only) against torch.fft.fft over the same
    rows, held to 2e-4 of scale, both timed: config 5's (2048, 4096) planes
    and K6's forward transforms, (C * Ta / hop, nfft) = (1024, 1024) rows."""
    out = {}
    for label_n, M, rows in (("M=4096", CH_M, CH_T // CH_M),
                             ("nfft=1024", 1024, C_FLAG * (T_FLAG // 32) // 512)):
        k = FusedPfbDft(M, CH_K).to(dev)
        x = torch.from_numpy(rng.standard_normal((2, rows * M)).astype(np.float32)).to(dev)
        tail = k.init_state(1)
        (yr, yi), _ = k.step_planes(tail, x[0], x[1], variant="dft_only")
        planes = torch.complex(x[0], x[1]).reshape(rows, M)
        ref = torch.fft.fft(planes, dim=-1)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float(torch.maximum((yr - ref.real).abs().max(), (yi - ref.imag).abs().max())) / scale
        check(err <= CH_PLANE_TOL, f"rf::fft {label_n}: {err:.3g} of scale against torch.fft.fft")
        ours = lambda: k._launch(tail, x[0], x[1], "dft_only")  # noqa: E731
        lib_fn = lambda: torch.fft.fft(planes, dim=-1)  # noqa: E731
        with torch.no_grad():
            ms, lib = median_ms(ours), median_ms(lib_fn)
            dev_ms, dev_lib = device_ms(ours), device_ms(lib_fn)
        b_ms, b_by = bound(16 * rows * M, 5 * rows * M * np.log2(M))
        print(f"[k9] rf::fft {label_n} over ({rows}, {M}): max|err| {err:.3e} of scale against "
              f"torch.fft.fft; CUDA events {ms:.4f} ms, torch.fft.fft {lib:.4f} ms; device time "
              f"(torch.profiler) {dev_ms:.4f} ms, torch.fft.fft {dev_lib:.4f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}) ({label})")
        out[label_n] = {"err": err, "ms": ms, "library_ms": lib, "device_ms": dev_ms,
                        "library_device_ms": dev_lib, "bound_ms": b_ms}
    return out


# --- config 3: the time-sharded chain, ranks on one card (K7) ---------------------------------

SHARD_RANKS = 4
SHARD_TIMEOUT_S = 600.0
# (label, C, global T, H, dtype): tests/test_halo_dma.py's cases at D=4, then
# the full-width halo of the slice's K2 (J0*R = 32 raw samples)
HALO_CASES = (("c64 H=4", 2, 64, 4, "c64"), ("f32 H=3", 2, 64, 3, "f32"),
              ("full width C=128 H=32", C_FLAG, T_FLAG, 32, "c64"))
# (mesh, channels): the slice at full width, and config 3's 64 channels on 2x2
SHARD_MESHES = (((1, SHARD_RANKS), C_FLAG), ((2, 2), 64))
SHARD_BLOCKS = 4
DECIM_TOL = 1e-6  # the raw-IQ carry (tests/test_fused_frontend.py:151)


def sharded_config(channels: int, transport: str) -> RxConfig:
    """The slice configuration with the given halo transport."""
    return dataclasses.replace(slice_config(channels), halo_transport=transport)


def _shard_inputs(C: int):
    """(freqs, modes, blocks): the same on every rank and here, from a seed."""
    rng = np.random.default_rng(SEED + 8)
    freqs = np.linspace(-5e5, 5e5, C)
    modes = np.arange(C) % 4
    return freqs, modes, [_slice_iq(rng, freqs, modes, b) for b in range(SHARD_BLOCKS)]


HALO_RUN = 60  # consecutive exchanges with no host wait, past the slot and ack parity


def _rank_halo(mesh, dev) -> dict:
    """One rank of the halo-kernel phase: K7 against its plain version (the
    ppermute transport), three exchanges per case (both slots, then a slot
    reused), then the per-call CUDA-event medians of both; then HALO_RUN
    exchanges of the full-width case enqueued back to back, each held
    against the plain route afterwards; last, the mismatch words."""
    ax = mesh.axis("time")
    dma = HaloDma(ax)
    out = {}
    for label, C, T, H, dtype in HALO_CASES:
        g = torch.Generator(device=dev).manual_seed(SEED + 100 * ax.index + C + H)
        x = torch.randn((C, T // ax.size), generator=g, device=dev)
        if dtype == "c64":
            x = torch.complex(x, torch.randn((C, T // ax.size), generator=g, device=dev))
        equal, err = True, 0.0
        for _ in range(3):
            k, p = ring_halo_dma(x, H, dma), plain_ring_halo(x, H, ax)
            torch.cuda.synchronize()
            equal = equal and bool(torch.equal(k, p))
            err = max(err, float((k - p).abs().max()))
        out[label] = {"equal": equal, "err": err,
                      "ms": median_ms(lambda: ring_halo_dma(x, H, dma), runs=25, inner=1),
                      "plain_ms": median_ms(lambda: plain_ring_halo(x, H, ax), runs=25, inner=1)}
    x = torch.randn((C_FLAG, T_FLAG // ax.size), generator=g, device=dev)
    xs = [torch.complex(x + i, x - i) for i in range(HALO_RUN)]
    got = [ring_halo_dma(xi, 32, dma) for xi in xs]  # the host waits for none of them
    torch.cuda.synchronize()
    out["run"] = all(bool(torch.equal(k, plain_ring_halo(xi, 32, ax))) for k, xi in zip(got, xs))
    out["mismatches"] = dma.mismatches()
    out["launches"] = dma.launches
    dma.close()
    return out


def sharded_duplex_configs(C: int) -> tuple[RxConfig, TxConfig]:
    """The sharded duplex: the RX options variant "nb nr notch vad" at depth
    1 (K2) with the rdma halo (K7), and the duplex TX with the mic EQ."""
    rx, tx = duplex_configs(C, mic_eq_bands=TX_EQ)
    return rx_options_config("nb nr notch vad", C, fuse_frontend_depth=1,
                             halo_transport="rdma"), tx


def _rank_duplex(mesh, dev, C: int) -> dict:
    """One rank of the sharded-duplex phase: ShardedDuplex over
    DPX_BLOCKS global blocks (FM carriers in the NFM channels, every TX mode
    with LSB), K2's and K7's counts set to 0 just before and read just after;
    host ms per step on every rank. Rank 0 then steps the unsharded
    DuplexChain on the card from the gathered state that entered each block
    and returns the differences, and steps it again free from the initial
    state over all the blocks: the two float32 FM phase integrators drift
    apart (F3), so the free run's FM phase and TX IQ are held to a bound
    that grows by FM_DRIFT_PER_BLOCK a block."""
    rx_cfg, tx_cfg = sharded_duplex_configs(C)
    freqs = np.linspace(-5e5, 5e5, C)
    rx_modes = (np.arange(C) % 4).astype(np.int32)
    tx_modes = (np.arange(C) % 5).astype(np.int32)
    rng = np.random.default_rng(SEED + 34)
    iq = _fm_iq(rng, freqs, rx_modes, DPX_BLOCKS)
    audio = _tx_inputs(rng, C, T_FLAG // 32, DPX_BLOCKS)
    words = nco.freq_word(freqs, FS_IN)
    ca, ta = mesh.axis("channel"), mesh.axis("time")
    cs = slice(ca.index * (C // ca.size), (ca.index + 1) * (C // ca.size))

    def local(x):
        n = x.shape[-1] // ta.size
        return _dev(x[cs, ta.index * n:(ta.index + 1) * n], dev)

    sharded = ShardedDuplex(DuplexChain(rx_cfg, tx_cfg).to(dev), mesh)
    specs = sharded.state_specs()
    st = shard_state(sharded.init_state(C), specs, mesh)
    args = [_dev(v[cs], dev) for v in (words, rx_modes, words, tx_modes)]
    k2, k7 = sharded.dpx.rx.fused, sharded.rx.halo
    k2.launches = k7.launches = 0
    got, ms = [], []

    def gather(x):
        x = torch.cat(list(ta.all_gather(x)), dim=-1)
        return torch.cat(list(ca.all_gather(x)), dim=0)

    with torch.no_grad():
        for x, a in zip(iq, audio):
            entering = gather_state(st, specs, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, rx_a, tx_iq, aux = sharded.step(st, local(x), local(a), *args)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got.append((gather(rx_a), gather(tx_iq), gather(aux["vad_active"]), entering))
    out = {"launches": {"fused_frontend": k2.launches, "halo_dma": k7.launches}, "ms": ms}
    state = gather_state(st, specs, mesh)
    sharded.close()
    if mesh.rank != 0:
        return out
    ref = DuplexChain(rx_cfg, tx_cfg).to(dev)
    ref_args = [_dev(v, dev) for v in (words, rx_modes, words, tx_modes)]
    out["blocks"] = []
    for (a, x, v, entering), x_in, a_in in zip(got, iq, audio):
        with torch.no_grad():
            ref_st, a_r, x_r, aux_r = ref.step(entering, _dev(x_in, dev), _dev(a_in, dev),
                                               *ref_args)
        e_a = np.abs(_nfm_mod((a - a_r).cpu().numpy(), rx_modes, FLAG_NFM_PERIOD)).max()
        out["blocks"].append({
            "finite": bool(torch.isfinite(a).all()) and bool(torch.isfinite(x).all()),
            "rx": float(e_a), "tx": float((x - x_r).abs().max()),
            "lsb": float((x - x_r)[torch.from_numpy(tx_modes == 4).to(dev)].abs().max()),
            "vad_diff": int((v != aux_r["vad_active"]).sum()), "vad_n": v.numel()})
    phasor = lambda st: torch.polar(torch.ones_like(st["tx"]["fm_phase"]),  # noqa: E731
                                    st["tx"]["fm_phase"])
    out["fm_phase"] = float((phasor(state) - phasor(ref_st)).abs().max())
    # the free run: the sharded state after each block against the unsharded
    # chain stepped from the initial state
    free, out["free"] = ref.init_state(C), []
    after = [g[3] for g in got[1:]] + [state]
    for (_, x, _, _), x_in, a_in, st_sh in zip(got, iq, audio, after):
        with torch.no_grad():
            free, _, x_f, _ = ref.step(free, _dev(x_in, dev), _dev(a_in, dev), *ref_args)
        out["free"].append({"fm_phase": float((phasor(st_sh) - phasor(free)).abs().max()),
                            "tx": float((x - x_f).abs().max())})
    out["nco"] = bool(torch.equal(state["tx"]["nco"], ref_st["tx"]["nco"])
                      and torch.equal(state["rx"]["nco"], ref_st["rx"]["nco"]))
    return out


def _rank_sharded(mesh, dev, C: int) -> dict:
    """One rank of the sharded-slice phase: Radio(mesh=...) for each halo
    transport over SHARD_BLOCKS global blocks, K2's and K7's counts set to 0
    just before and read just after; audio and the gathered raw-IQ carry on
    rank 0, host ms per Radio.process on every rank."""
    freqs, modes, iq = _shard_inputs(C)
    out = {}
    for transport in ("rdma", "ppermute"):
        radio = Radio(sharded_config(C, transport), device=dev, mesh=mesh)
        for ch in range(C):
            radio.tune(ch, float(freqs[ch]))
            radio.set_mode(ch, ("ssb", "cw", "am", "nfm")[modes[ch]])
        k2, k7 = radio.chain.fused, radio.sharded.halo
        k2.launches = k7.launches = 0
        audio, ms = [], []
        for x in iq:
            t0 = time.perf_counter()
            audio.append(radio.process(x))
            ms.append((time.perf_counter() - t0) * 1e3)
        res = {"launches": {"fused_frontend": k2.launches, "halo_dma": k7.launches}, "ms": ms,
               "power_in": radio.metrics()["power_in"]}
        decim0 = radio.global_state()["decim"][0].cpu().numpy()
        if mesh.rank == 0:
            res.update(audio=audio, decim0=decim0)
        out[transport] = res
        radio.close()
    return out


# config 5 on a (1, 4) mesh: form -> (the preset's changes, modes)
SC_FORMS = {"xla": ({}, np.arange(CH_M) % 4),
            "emit_env": (dict(enabled_modes=(SSB, CW, NFM, LSB)), EMIT_MODES),
            "two-kernel": (dict(fuse_single_pass=False), np.arange(CH_M) % 4)}
SC_BLOCKS = 2


def _sc_inputs() -> list:
    """The sharded channelizer's global blocks, the same on every rank and
    here: noise plus a carrier in each NFM channel (every form's NFM channels
    are those of arange(M) % 4)."""
    rng = np.random.default_rng(SEED + 11)
    out = []
    for _ in range(SC_BLOCKS):
        x = _wideband(rng, CH_T, CH_M, np.arange(CH_M) % 4)
        out.append((x[0] + 1j * x[1]).astype(np.complex64))
    return out


def _sc_monitor(cfg, modes, dev, mesh=None) -> Monitor:
    mon = Monitor(cfg, device=dev, mesh=mesh)
    for c in range(CH_M):
        mon.set_mode(c, CH_NAMES[modes[c]])
    return mon


def _rank_channelizer(mesh, dev) -> dict:
    """One rank of the sharded-channelizer phase: Monitor(mesh=...) in each
    of SC_FORMS over SC_BLOCKS global blocks, the kernels' counts set to 0
    just before and read just after; host ms per Monitor.process on every
    rank; outputs and the gathered state on rank 0; for the two-kernel form
    the host ms of the all_to_all of one block's planes."""
    wide = _sc_inputs()
    out = {}
    for form, (change, modes) in SC_FORMS.items():
        mon = _sc_monitor(dataclasses.replace(presets.channelizer_61m44(CH_M), **change), modes,
                          dev, mesh)
        sh = mon.sharded
        kernels = {"pfb_dft": mon.chain.pfb, "demod_agc": sh.demod_kernel,
                   "channelizer_one": sh.one_kernel}
        kernels = {k: v for k, v in kernels.items() if v is not None}
        for k in kernels.values():
            k.launches = 0
        res = {"ms": [], "audio": [], "waterfall": [], "channel_power": []}
        for x in wide:
            t0 = time.perf_counter()
            a = mon.process(x)
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            if mesh.rank == 0:
                res["audio"].append(a)
                res["waterfall"].append(mon.waterfall())
                res["channel_power"].append(mon.channel_power())
        res["launches"] = {k: v.launches for k, v in kernels.items()}
        res["one_mode"] = sh.one_mode
        state = mon.global_state()
        if mesh.rank == 0:
            res["state"] = {"cw_phase": state["demod"]["cw_phase"].cpu().numpy(),
                            "pfb": state["pfb"].cpu().numpy(),
                            "rows": _pack_backend_state(state["demod"], state["agc"]).cpu().numpy()}
        if sh.demod_kernel is not None:
            ax = mesh.axis("time")
            planes = torch.randn((2, CH_T // CH_M // ax.size, CH_M), device=dev)
            runs = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ax.all_to_all(planes, 2, 1)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            res["all_to_all_ms"] = statistics.median(runs[1:])
            res["all_to_all_mb"] = planes.numel() * planes.element_size() * ax.size / 1e6
        out[form] = res
    return out


def _sharded_rank(rank: int, world: int, device: str, directory: str) -> dict:
    """Everything one rank runs: the halo-kernel cases on a (1, 4) mesh, the
    slice on each of SHARD_MESHES, then the sharded channelizer on (1, 4),
    save/load under the (1, 4) mesh (checkpoints under ``directory``) and
    the hybrid mesh, all on ``device`` (the one card)."""
    dev = torch.device(device)
    out = {"halo": _rank_halo(make_mesh(1, world, device=dev), dev)}
    for shape, C in SHARD_MESHES:
        mesh = make_mesh(*shape, device=dev)
        out[shape] = _rank_sharded(mesh, dev, C)
        out[("duplex", shape)] = _rank_duplex(mesh, dev, C)
    mesh = make_mesh(1, world, device=dev)
    out["channelizer"] = _rank_channelizer(mesh, dev)
    out["checkpoint"] = _rank_checkpoint(mesh, dev, directory)
    out["hybrid"] = _rank_hybrid(world, dev)
    return out


def _sharded_channelizer(ranks: list, dev, label: str) -> int:
    """sharded-channelizer: each form of the (1, 4) run held against the
    unsharded port Monitor on the card. Returns the emit_env variant's K5
    launches, summed over the ranks."""
    wide = _sc_inputs()
    res = [r["channelizer"] for r in ranks]
    for form, (change, modes) in SC_FORMS.items():
        cfg = dataclasses.replace(presets.channelizer_61m44(CH_M), **change)
        ref = _sc_monitor(cfg, modes, dev)
        got = res[0][form]
        for i, r in enumerate(res):
            for k, n in r[form]["launches"].items():
                # rank 0 seeds its lookbacks from the block state, not a K3 frame
                if not (k == "pfb_dft" and form != "two-kernel" and i == 0):
                    check(n > 0, f"sharded channelizer {form} rank {i}: {k} not launched")
        want = {"xla": "xla", "emit_env": "emit_env", "two-kernel": None}[form]
        check(got["one_mode"] == want, f"sharded channelizer {form}: tier {got['one_mode']}")
        for blk, x in enumerate(wide):
            a_ref = ref.process(x)
            a = got["audio"][blk]
            check(a.shape == a_ref.shape == (CH_M, CH_T // CH_M) and bool(np.isfinite(a).all()),
                  f"sharded channelizer {form} block {blk}: audio shape {a.shape} / finite")
            err = float(np.abs(_nfm_mod(a - a_ref, modes, NFM_PERIOD)).max())
            wf_err = float(np.abs(got["waterfall"][blk] - ref.waterfall()).max())
            cp_rel = float(np.abs(got["channel_power"][blk] / ref.channel_power() - 1).max())
            if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
                check(err <= CH_TOL, f"sharded channelizer {form} block {blk}: audio {err:.3g}")
            check(wf_err <= WF_TOL_DB, f"sharded channelizer {form} block {blk}: waterfall "
                                       f"{wf_err:.3g} dB")
            check(cp_rel <= 1e-4, f"sharded channelizer {form} block {blk}: channel power "
                                  f"{cp_rel:.3g}")
            print(f"[sharded-channelizer] {form} block {blk}: audio {a.shape} finite; max|sharded "
                  f"- unsharded Monitor| {err:.3e}{' (cold start, not held)' if blk == 0 else ''}"
                  f"; waterfall {wf_err:.2e} dB; channel power rel {cp_rel:.2e}")
        st, st_ref = got["state"], ref.state
        rows_ref = _pack_backend_state(st_ref["demod"], st_ref["agc"])
        c_err = _carry_err(torch.from_numpy(st["rows"]).to(dev), rows_ref)
        pfb_err = float(np.abs(st["pfb"] - st_ref["pfb"].cpu().numpy()).max())
        check(np.array_equal(st["cw_phase"], st_ref["demod"]["cw_phase"].cpu().numpy()),
              f"sharded channelizer {form}: cw_phase")
        check(c_err <= CH_TOL and pfb_err <= 1e-6,
              f"sharded channelizer {form}: state rows {c_err:.3g}, pfb {pfb_err:.3g}")
        ms = ", ".join("/".join(f"{m:.1f}" for m in r[form]["ms"]) for r in res)
        extra = ""
        if "all_to_all_ms" in got:
            extra = (f"; all_to_all of one block's planes ({got['all_to_all_mb']:.0f} MB in "
                     "all, staged through host memory) host ms by rank "
                     + ", ".join(f"{r[form]['all_to_all_ms']:.1f}" for r in res))
        print(f"[sharded-channelizer] {form}: state rows {c_err:.2e} (relative), pfb "
              f"{pfb_err:.1e}, cw_phase bit-equal; launches per rank "
              f"{[r[form]['launches'] for r in res]}; Monitor.process host ms per block (block "
              f"0/1) by rank {ms}{extra} ({SHARD_RANKS} processes time-slicing one card, not a "
              f"deployment rate; {label})")
    return sum(r["emit_env"]["launches"]["channelizer_one"] for r in res)


def _sharded_duplex(ranks: list, label: str) -> dict:
    """sharded-duplex: each mesh's ShardedDuplex against the unsharded
    DuplexChain on the card (rank 0's differences). Returns K2's and K7's
    launches summed over the ranks and meshes."""
    launches = {"fused_frontend": 0, "halo_dma": 0}
    for shape, C in SHARD_MESHES:
        res = [r[("duplex", shape)] for r in ranks]
        for i, r in enumerate(res):
            for k in ("fused_frontend", "halo_dma"):
                check(r["launches"][k] > 0, f"sharded duplex {shape} rank {i}: {k} not launched")
        got = res[0]
        for blk, b in enumerate(got["blocks"]):
            check(b["finite"], f"sharded duplex {shape} block {blk}: finite")
            if blk > 0:  # block 0: cold-start AGC, NR and VAD transients
                check(b["rx"] <= CHAIN_TOL, f"sharded duplex {shape} block {blk}: RX {b['rx']:.3g}")
            check(b["tx"] <= TX_TOL, f"sharded duplex {shape} block {blk}: TX {b['tx']:.3g}")
            check(b["vad_diff"] == 0, f"sharded duplex {shape} block {blk}: {b['vad_diff']} VAD "
                                      "flags differ")
            print(f"[sharded-duplex] mesh {shape} C={C} block {blk}: max|sharded - unsharded "
                  f"DuplexChain| RX audio {b['rx']:.3e}"
                  f"{' (cold start, not held)' if blk == 0 else ''}, TX IQ {b['tx']:.3e} (LSB "
                  f"channels {b['lsb']:.3e}); VAD flags equal ({b['vad_n']} frames)")
        check(got["fm_phase"] <= FM_PHASE_TOL, f"sharded duplex {shape}: fm_phase "
                                               f"{got['fm_phase']:.3g}")
        for blk, f in enumerate(got["free"]):
            ph_bound, tx_bound = (blk + 1) * FM_DRIFT_PER_BLOCK, TX_TOL + blk * FM_DRIFT_PER_BLOCK
            check(f["fm_phase"] <= ph_bound, f"sharded duplex {shape} run free, block {blk}: "
                                             f"fm_phase {f['fm_phase']:.3g} > {ph_bound:.3g}")
            check(f["tx"] <= tx_bound, f"sharded duplex {shape} run free, block {blk}: TX IQ "
                                       f"{f['tx']:.3g} > {tx_bound:.3g}")
            print(f"[sharded-duplex] mesh {shape} run free, block {blk}: fm_phase as phasors "
                  f"{f['fm_phase']:.3e} (bound {ph_bound:.2e}), TX IQ {f['tx']:.3e} "
                  f"(bound {tx_bound:.2e})")
        check(got["nco"], f"sharded duplex {shape}: NCO accumulators")
        ms = [statistics.median(r["ms"][1:]) for r in res]
        print(f"[sharded-duplex] mesh {shape}: fm_phase as phasors {got['fm_phase']:.2e}; NCOs "
              f"bit-equal; launches per rank {[r['launches'] for r in res]}; ShardedDuplex.step "
              f"host ms per block by rank {', '.join(f'{m:.2f}' for m in ms)} ({SHARD_RANKS} "
              f"processes time-slicing one card, not a deployment rate; {label})")
        for k in ("fused_frontend", "halo_dma"):
            launches[k] += sum(r["launches"][k] for r in res)
    return launches


CKPT_BLOCKS = 4  # 2 before the save, 2 after


def _ckpt_radio(mesh, dev) -> Radio:
    freqs, modes, _ = _shard_inputs(C_FLAG)
    radio = Radio(sharded_config(C_FLAG, "rdma"), device=dev, mesh=mesh)
    for ch in range(C_FLAG):
        radio.tune(ch, float(freqs[ch]))
        radio.set_mode(ch, ("ssb", "cw", "am", "nfm")[modes[ch]])
    return radio


def _ckpt_radio_blocks() -> list:
    rng = np.random.default_rng(SEED + 80)
    freqs, modes, _ = _shard_inputs(C_FLAG)
    return [_slice_iq(rng, freqs, modes, b) for b in range(CKPT_BLOCKS)]


def _ckpt_monitor_config():
    return dataclasses.replace(presets.channelizer_61m44(CH_M), **SC_FORMS["emit_env"][0])


def _ckpt_monitor_blocks() -> list:
    rng = np.random.default_rng(SEED + 81)
    out = []
    for _ in range(CKPT_BLOCKS):
        x = _wideband(rng, CH_T, CH_M, np.arange(CH_M) % 4)
        out.append((x[0] + 1j * x[1]).astype(np.complex64))
    return out


def _rank_checkpoint(mesh, dev, directory: str) -> dict:
    """One rank of the mesh-checkpoint phase: Radio(mesh=(1, 4)) on the
    sharded slice (K2 + K7) at C=128 and Monitor(mesh=(1, 4)) in the
    emit_env form at F_local 512 each run 2 blocks, save, and run 2 more; a
    fresh object loads and runs the same 2 blocks. The kernels' counts are
    set to 0 just before the first object's run and read after the second's.
    Rank 0 returns the audio."""
    out = {}
    for name in ("radio", "monitor"):
        if name == "radio":  # the fresh object's controls come from the checkpoint
            objs = [_ckpt_radio(mesh, dev), Radio(sharded_config(C_FLAG, "rdma"), device=dev,
                                                  mesh=mesh)]
            blocks = _ckpt_radio_blocks()
            kernels = lambda o: {"fused_frontend": o.chain.fused,  # noqa: E731
                                 "halo_dma": o.sharded.halo}
        else:
            objs = [_sc_monitor(_ckpt_monitor_config(), SC_FORMS["emit_env"][1], dev, mesh),
                    Monitor(_ckpt_monitor_config(), device=dev, mesh=mesh)]
            blocks = _ckpt_monitor_blocks()
            kernels = lambda o: {"channelizer_one_emit_env": o.sharded.one_kernel}  # noqa: E731
        first, fresh = objs
        for o in objs:
            for k in kernels(o).values():
                k.launches = 0
        for b in blocks[:2]:
            first.process(b)
        path = first.save(os.path.join(directory, name), epoch=2)
        cont = [first.process(b) for b in blocks[2:]]
        epoch = fresh.load(os.path.join(directory, name))
        resumed = [fresh.process(b) for b in blocks[2:]]
        n = {k: sum(kernels(o)[k].launches for o in objs) for k in kernels(first)}
        res = {"launches": n, "epoch": epoch, "path": path,
               "equal": all(np.array_equal(a, b) for a, b in zip(cont, resumed)),
               "modes_back": [fresh.mode(c) for c in range(8)]}
        if mesh.rank == 0:
            res["cont"] = cont
        if name == "radio":
            for o in objs:
                o.close()
        out[name] = res
    return out


def _rank_hybrid(world: int, dev) -> dict:
    """make_hybrid_mesh(1, 2, device="cuda") with LOCAL_WORLD_SIZE=2 (two
    "hosts" sharing the one card): this rank's place, and one ShardedRxChain
    step (the sharded slice, C=64) on it and on make_mesh(2, 2), gathered."""
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        hyb = make_hybrid_mesh(1, world // 2, device="cuda")
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    C = 64
    freqs, modes, iq = _shard_inputs(C)
    cfg = sharded_config(C, "rdma")
    outs = []
    for mesh in (hyb, make_mesh(2, world // 2, device=dev)):
        ca, ta = mesh.axis("channel"), mesh.axis("time")
        cs = slice(ca.index * (C // ca.size), (ca.index + 1) * (C // ca.size))
        n = T_FLAG // ta.size
        sh = ShardedRxChain(RxChain(cfg).to(dev), mesh)
        st = shard_state(sh.init_state(C), sh.state_specs(), mesh)
        x = _dev(iq[0][cs, ta.index * n:(ta.index + 1) * n], dev)
        with torch.no_grad():
            st, a, _ = sh.step(st, x, _dev(nco.freq_word(freqs, FS_IN)[cs], dev),
                               _dev(modes[cs].astype(np.int32), dev))
        sh.check()
        a = torch.cat(list(ta.all_gather(a)), dim=1)
        outs.append(torch.cat(list(ca.all_gather(a)), dim=0).cpu().numpy())
        sh.close()
    return {"index": (hyb.index("channel"), hyb.index("time")), "shape": dict(hyb.shape),
            "device": str(hyb.device), "equal": bool(np.array_equal(*outs))}


def _mesh_checkpoint(ranks: list, dev, directory: str, label: str) -> dict:
    """mesh-checkpoint: each rank's resume bit-equal to its uninterrupted
    run; the checkpoint loaded into an unsharded object on the card continues
    within 2e-4 of the sharded run (NFM rows modulo fs/deviation); the
    hybrid mesh's layout against the reference's host-major formula and its
    step bit-equal to make_mesh(2, 2)'s. Returns the launches summed over
    the ranks."""
    launches = {}
    for name in ("radio", "monitor"):
        res = [r["checkpoint"][name] for r in ranks]
        for i, r in enumerate(res):
            check(r["equal"] and r["epoch"] == 2,
                  f"mesh checkpoint {name} rank {i}: resume not bit-equal (epoch {r['epoch']})")
            for k, n in r["launches"].items():
                check(n > 0, f"mesh checkpoint {name} rank {i}: {k} not launched")
                launches[k] = launches.get(k, 0) + n
        if name == "radio":
            ref = Radio(slice_config(C_FLAG), device=dev)
            blocks, period = _ckpt_radio_blocks(), FLAG_NFM_PERIOD
            modes = _shard_inputs(C_FLAG)[1]
            want_modes = [("ssb", "cw", "am", "nfm")[m] for m in modes[:8]]
        else:
            ref = Monitor(_ckpt_monitor_config(), device=dev)
            blocks, period, modes = _ckpt_monitor_blocks(), NFM_PERIOD, SC_FORMS["emit_env"][1]
            want_modes = [CH_NAMES[m] for m in modes[:8]]
        check(ref.load(os.path.join(directory, name)) == 2, f"{name}: unsharded load epoch")
        check(all(r["modes_back"] == want_modes for r in res), f"{name}: modes not restored")
        errs = []
        for blk, (x, a_sh) in enumerate(zip(blocks[2:], res[0]["cont"])):
            a = ref.process(x)
            errs.append(float(np.abs(_nfm_mod(a - a_sh, modes, period)).max()))
            check(errs[-1] <= CHAIN_TOL, f"{name} block {blk + 2}: unsharded load vs sharded "
                                         f"{errs[-1]:.3g}")
        print(f"[mesh-checkpoint] {name} on (1, 4): resume from epoch 2 bit-equal to the "
              f"uninterrupted run on every rank; checkpoint {res[0]['path']} (written by rank 0) "
              f"loaded unsharded on the card: max|unsharded - sharded| "
              f"{', '.join(f'{e:.3e}' for e in errs)} over blocks 2-3; launches per rank "
              f"{[r['launches'] for r in res]} ({label})")
    order = sorted(range(SHARD_RANKS), key=lambda r: (r // 2, r))  # (process_index, id)
    host_major = np.asarray(order).reshape(2, 1, SHARD_RANKS // 2).reshape(2, SHARD_RANKS // 2)
    for rank, r in enumerate(ranks):
        h = r["hybrid"]
        check(h["shape"] == {"channel": 2, "time": SHARD_RANKS // 2}
              and tuple(np.argwhere(host_major == rank)[0]) == h["index"],
              f"hybrid mesh rank {rank}: {h}")
        check(h["equal"], f"hybrid mesh rank {rank}: the step differs from make_mesh(2, 2)'s")
    print(f"[mesh-checkpoint] make_hybrid_mesh(1, 2, device='cuda') with LOCAL_WORLD_SIZE=2: "
          f"(channel, time) by rank {[r['hybrid']['index'] for r in ranks]} on "
          f"{ranks[0]['hybrid']['device']}, the reference's host-major layout; one "
          f"ShardedRxChain step bit-equal to make_mesh(2, 2)'s on every rank")
    return launches


def phase_sharded(dev, label: str) -> tuple[float, dict, dict]:
    """halo-kernel, sharded-slice and sharded-channelizer: SHARD_RANKS
    processes on the one card (gloo, file rendezvous), K7 bit-equal to its
    plain version in every rank; the sharded Radio (K2 + K7 + the composed
    back end) held against the unsharded port chain on the card (K2 + K6)
    and against the same sharded chain with the ppermute halo; the sharded
    Monitor's three forms against the unsharded Monitor. Returns K7's worst
    error, the launches of the (1, 4) rdma run and of K5's emit_env variant
    summed over ranks, and K7's kernel-line times."""
    t0 = time.perf_counter()
    card = torch.device(dev.type, torch.cuda.current_device() if dev.index is None else dev.index)
    with tempfile.TemporaryDirectory() as ckpt:
        ranks = spawn(_sharded_rank, SHARD_RANKS, str(card), ckpt, timeout_s=SHARD_TIMEOUT_S)
        print(f"[sharded] {SHARD_RANKS} ranks on one card, every phase below, "
              f"{time.perf_counter() - t0:.1f} s wall")
        ckpt_launches = _mesh_checkpoint(ranks, dev, ckpt, label)
    worst = 0.0
    for case in HALO_CASES:
        got = [r["halo"][case[0]] for r in ranks]
        for i, g in enumerate(got):
            check(g["equal"], f"K7 {case[0]} rank {i}: not bit-equal to the ppermute transport")
            worst = max(worst, g["err"])
        us = [1e3 * g["ms"] for g in got]
        pus = [1e3 * g["plain_ms"] for g in got]
        print(f"[halo-kernel] {case[0]} (C={case[1]}, T_local={case[2] // SHARD_RANKS}): bit-equal "
              f"on every rank; put+recv per rank {', '.join(f'{u:.1f}' for u in us)} us (CUDA "
              f"events, median of 25), ppermute {', '.join(f'{u:.1f}' for u in pus)} us ({label})")
    for i, r in enumerate(ranks):
        check(r["halo"]["run"], f"K7 rank {i}: a run of {HALO_RUN} exchanges differs from the "
                                "ppermute transport")
        check(r["halo"]["mismatches"] == 0,
              f"K7 rank {i}: {r['halo']['mismatches']} wrong sequence flags")
    print(f"[halo-kernel] {HALO_RUN} exchanges back to back (C={C_FLAG}, H=32): bit-equal on "
          f"every rank; mismatch words {[r['halo']['mismatches'] for r in ranks]}")
    full = [r["halo"][HALO_CASES[-1][0]] for r in ranks]
    C, H = HALO_CASES[-1][1], HALO_CASES[-1][3]
    b_ms, b_by = bound(2 * 8 * C * H, 0.0)
    times = {"ms": statistics.median(g["ms"] for g in full),
             "plain_ms": statistics.median(g["plain_ms"] for g in full),
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"[halo-kernel] bound: {2 * 8 * C * H} B -> {b_ms:.2e} ms ({b_by}); two launches and "
          "the cross-process wake-ups take far longer: latency is what the card shows")
    launches = {}
    for shape, C in SHARD_MESHES:
        freqs, modes, iq = _shard_inputs(C)
        ref = Radio(slice_config(C), device=dev)
        for ch in range(C):
            ref.tune(ch, float(freqs[ch]))
            ref.set_mode(ch, ("ssb", "cw", "am", "nfm")[modes[ch]])
        ref_audio = [ref.process(x) for x in iq]
        ref_power = ref.metrics()["power_in"]
        res = [r[shape] for r in ranks]
        for i, r in enumerate(res):
            for tr, need in (("rdma", ("fused_frontend", "halo_dma")),
                             ("ppermute", ("fused_frontend",))):
                for k in need:
                    check(r[tr]["launches"][k] > 0, f"mesh {shape} rank {i} {tr}: {k} not launched")
        got = res[0]
        for blk, a_ref in enumerate(ref_audio):
            a_r, a_p = got["rdma"]["audio"][blk], got["ppermute"]["audio"][blk]
            check(a_r.shape == a_ref.shape and bool(np.isfinite(a_r).all()),
                  f"mesh {shape} block {blk}: audio shape {a_r.shape} / finite")
            e_ref = float(np.abs(_nfm_mod(a_r - a_ref, modes, FLAG_NFM_PERIOD)).max())
            e_pp = float(np.abs(_nfm_mod(a_r - a_p, modes, FLAG_NFM_PERIOD)).max())
            if blk > 0:  # block 0: cold-start AGC transient amplifies ulps
                check(e_ref <= CHAIN_TOL,
                      f"mesh {shape} block {blk}: sharded vs unsharded {e_ref:.3g}")
                check(e_pp <= CHAIN_TOL, f"mesh {shape} block {blk}: rdma vs ppermute {e_pp:.3g}")
            print(f"[sharded-slice] mesh {shape} C={C} block {blk}: audio {a_r.shape} finite; "
                  f"max|sharded rdma - unsharded K2+K6 chain| {e_ref:.3e}; max|rdma - ppermute| "
                  f"{e_pp:.3e}{' (bit-equal)' if np.array_equal(a_r, a_p) else ''}"
                  f"{' (cold start, not held)' if blk == 0 else ''}")
        for tr in ("rdma", "ppermute"):
            d = float(np.abs(got[tr]["decim0"] - ref.state["decim"][0].cpu().numpy()).max())
            check(d <= DECIM_TOL, f"mesh {shape} {tr}: decim[0] {d:.3g}")
            # the psum of the ranks' K2 sums against the unsharded K2's sum
            p_rel = float(np.max(np.abs(got[tr]["power_in"] - ref_power) / ref_power))
            check(p_rel <= 1e-6, f"mesh {shape} {tr}: power_in rel {p_rel:.3g}")
            ms = [statistics.median(r[tr]["ms"][1:]) for r in res]
            print(f"[sharded-slice] mesh {shape} {tr}: decim[0] max|d| {d:.2e}; power_in rel "
                  f"{p_rel:.2e}; launches per rank "
                  f"{[r[tr]['launches'] for r in res]}; Radio.process host ms per block by rank "
                  f"{', '.join(f'{m:.2f}' for m in ms)} ({SHARD_RANKS} processes time-slicing one "
                  f"card, not a deployment rate; {label})")
        if shape == SHARD_MESHES[0][0]:
            launches = {k: sum(r["rdma"]["launches"][k] for r in res)
                        for k in ("halo_dma", "fused_frontend")}
    for k, n in _sharded_duplex(ranks, label).items():
        launches[k] += n
    launches["channelizer_one_emit_env"] = _sharded_channelizer(ranks, dev, label)
    for k, n in ckpt_launches.items():  # the mesh checkpoint's runs
        launches[k] += n
    return worst, launches, times



def _ch_work(M: int, K: int, F: int, modes: np.ndarray, wf_avg: int) -> dict:
    """(bytes, FP32 operations) each kernel must at least move and do. K5's
    emit_env variant (over EMIT_MODES: no AM DC block) adds the env store
    and does the release (2) in place of the AGC (10)."""
    T = F * M
    const = 4 * (K * M + M + 7 * M) + 8 * (K - 1) * M   # taps, twiddles, constants, tail
    back = 4 * F * M + 4 * (F // wf_avg) * M + 2 * 4 * 7 * M  # audio, waterfall, carries
    ops3 = 4 * K * T + 5 * F * M * np.log2(M)            # polyphase FMAs + the FFT
    ops4 = F * sum(3 + MODE_OPS[int(m)] + 4 + 10 + 2 for m in modes)
    ops_env = F * sum(3 + MODE_OPS[int(m)] + 2 + 2 for m in EMIT_MODES)
    return {"pfb_dft": (8 * T + const + 8 * F * M, ops3),
            "demod_agc": (8 * F * M + 4 * 8 * M + back, ops4),
            "channelizer_one": (8 * T + const + back, ops3 + ops4),
            "channelizer_one_emit_env": (8 * T + const + back + 4 * F * M, ops3 + ops_env)}


def phase_ch_time(dev, label: str) -> dict:
    """ms per config-5 block (CUDA events) of ChannelizerChain.step in its
    three forms, K3/K4/K5 alone and their plain versions, torch.fft.fft over
    the (F, M) planes (the DFT stage's yardstick), and Monitor.process on the
    host clock (numpy block in, numpy audio out)."""
    cfg = presets.channelizer_61m44(CH_M)
    g = torch.Generator(device=dev).manual_seed(SEED)
    wr = torch.randn(CH_T, generator=g, device=dev)
    wi = torch.randn(CH_T, generator=g, device=dev)
    wb = torch.complex(wr, wi)
    modes = np.arange(CH_M) % 4
    mode = torch.from_numpy(modes.astype(np.int32)).to(dev)
    forms = {"single-pass": cfg, "two-kernel": dataclasses.replace(cfg, fuse_single_pass=False),
             "dense": _dense_config(cfg)}
    chains = {k: ChannelizerChain(c).to(dev) for k, c in forms.items()}
    ms = {}
    with torch.no_grad():
        for form, chain in chains.items():
            st = [chain.init_state()]

            def step(chain=chain, st=st):
                st[0], _, _ = chain.step(st[0], wb, mode)
            ms[f"ChannelizerChain.step {form}"] = median_ms(step)
            host_both_ways(f"ChannelizerChain.step {form}", chain.step, chain.init_state(),
                           (wb, mode), label)
        one, two = chains["single-pass"], chains["two-kernel"]
        k3, k4, k5 = two.pfb, two.demod_kernel, one.one_kernel
        tail = k3.init_state(1)
        (yr, yi), _ = k3.step_planes(tail, wr, wi)
        rel, al, tgt, mg = one.agc_bank.per_channel(mode)
        word = torch.full((CH_M,), one.cw_tone_word, dtype=torch.int32, device=dev)
        consts = (mode, word, torch.zeros_like(word), rel, al, tgt, mg)
        st0 = _carry0(CH_M, dev)
        kw4 = dict(enabled=k4.en, fs=k4.fs, nfm_deviation_hz=k4.nfm_deviation_hz,
                   wf_avg=k4.wf_avg, apply_agc=k4.apply_agc)
        planes = torch.complex(yr, yi)
        ms["pfb_dft"] = median_ms(lambda: k3.step_planes(tail, wr, wi))
        ms["pfb_dft plain"] = median_ms(lambda: plain_pfb_dft(k3.h, tail, wr, wi))
        ms["demod_agc"] = median_ms(lambda: k4(yr, yi, *consts, st0))
        ms["demod_agc plain"] = median_ms(lambda: plain_demod_agc(yr, yi, *consts, st0, **kw4))
        # the chain's call: (M, F) audio; the frame-major call and the
        # transposed copy the chain made after it before K5 wrote (M, F)
        ms["channelizer_one"] = median_ms(
            lambda: k5.call_planes(tail, wr, wi, *consts, st0, channel_major=True))
        ms["channelizer_one frame-major"] = median_ms(
            lambda: k5.call_planes(tail, wr, wi, *consts, st0))
        ms["channelizer_one frame-major + transposed copy"] = median_ms(
            lambda: k5.call_planes(tail, wr, wi, *consts, st0)[0].T.contiguous())
        ms["channelizer_one plain"] = median_ms(
            lambda: plain_channelizer_one(k5, tail, wr, wi, *consts, st0))
        k5e = FusedChannelizerOne(CH_M, CH_K, k5.fs, k5.nfm_deviation_hz, wf_avg=k5.wf_avg,
                                  enabled=(SSB, CW, NFM, LSB), apply_agc=False,
                                  emit_env=True).to(dev)
        mode_e = torch.from_numpy(EMIT_MODES.astype(np.int32)).to(dev)
        rel_e, al_e, tgt_e, mg_e = one.agc_bank.per_channel(mode_e)
        consts_e = (mode_e, word, torch.zeros_like(word), rel_e, al_e, tgt_e, mg_e)
        ms["channelizer_one_emit_env"] = median_ms(
            lambda: k5e.call_planes(tail, wr, wi, *consts_e, st0))
        ms["channelizer_one_emit_env plain"] = median_ms(
            lambda: plain_channelizer_one(k5e, tail, wr, wi, *consts_e, st0))
        # as the sharded path launches it: one rank's quarter of the block
        n_loc = CH_T // SHARD_RANKS
        loc_ms = median_ms(lambda: k5e.call_planes(tail, wr[:n_loc], wi[:n_loc], *consts_e, st0))
        ms["torch.fft.fft (F, M) planes"] = median_ms(lambda: torch.fft.fft(planes, dim=-1))
    mon = Monitor(cfg, device=dev)
    for c in range(CH_M):
        mon.set_mode(c, CH_NAMES[modes[c]])
    block = wb.cpu().numpy()
    # returns numpy: ends after the device-to-host copy
    ms["Monitor.process (host clock)"] = host_ms(lambda: mon.process(block))
    # where Monitor.process's host time goes (host clock, synchronized)
    with torch.no_grad():
        x_dev = mon._stager.to_device(block, np.complex64)
        mst = mon.state  # a copy: Monitor's own buffers belong to its CUDA graph
        _, audio_dev, _ = mon.chain.step(mst, x_dev, mode)
        parts = {
            "pinned staging and host-to-device copy of the block":
                lambda: mon._stager.to_device(block, np.complex64),
            "ChannelizerChain.step on the complex block (strided planes)":
                lambda: mon.chain.step(mst, x_dev, mode),
            "the same step replayed as Monitor's CUDA graph (with the block's copy in)":
                lambda: mon._compiled(x_dev, mode),
            "device-to-host copy of the audio (page-locked)":
                lambda: mon._stager.to_host(audio_dev),
            "device-to-host copy of the audio (.cpu(), pageable)":
                lambda: audio_dev.cpu().numpy(),
        }
        for what, fn in parts.items():
            runs = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0) * 1e3)
            print(f"[time] Monitor.process part, {what}: {statistics.median(runs):.4f} ms "
                  f"(host clock, {label})")
    for what, t in ms.items():
        print(f"[time] {what}: {t:.4f} ms/block, {CH_T / (t * 1e-3):.4g} wideband samples/s "
              f"({label})")
    print(f"[time] real-time limit: {1e3 * CH_T / cfg.fs_in:.2f} ms per block of air")
    rows = {}
    for name, (nbytes, ops) in _ch_work(CH_M, CH_K, CH_T // CH_M, modes, k4.wf_avg).items():
        b_ms, b_by = bound(nbytes, ops)
        print(f"[time] {name} bound: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} GFLOP -> "
              f"{b_ms:.4f} ms ({b_by}); kernel at {b_ms / ms[name]:.1%} of it")
        rows[name] = {"ms": ms[name], "plain_ms": ms[f"{name} plain"], "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}
    rows["pfb_dft"]["fft_yardstick_ms"] = ms["torch.fft.fft (F, M) planes"]
    F_loc = CH_T // CH_M // SHARD_RANKS
    b_ms, _ = bound(*_ch_work(CH_M, CH_K, F_loc, modes, k4.wf_avg)["channelizer_one_emit_env"])
    rows["channelizer_one_emit_env"].update(path_ms=loc_ms, path_bound_ms=b_ms)
    print(f"[time] channelizer_one_emit_env at the sharded path's F_local={F_loc}: "
          f"{loc_ms:.4f} ms, bound {b_ms:.4f} ms ({label})")
    return rows


def _am_tone(M: int, F: int, fs_in: float):
    """An AM tone (1 kHz, depth 0.8) at channel 37's center: (wideband, tone)."""
    fs_ch = fs_in / M
    tone = 0.7 * np.sin(2 * np.pi * 1000.0 * np.arange(F) / fs_ch)
    up = np.repeat((1.0 + 0.8 * tone).astype(np.complex128), M)
    wide = up * np.exp(2j * np.pi * (37 * fs_ch) * (np.arange(F * M) / fs_in))
    return wide.astype(np.complex64), tone


def _ch_snr(device, wide, tone, blocks: int) -> float:
    mon = Monitor(presets.channelizer_61m44(CH_M), device=device)
    mon.set_mode_all("am")
    audio = np.concatenate([mon.process(b) for b in np.split(wide, blocks)], axis=-1)
    check(int(np.argmax(mon.channel_power())) == 37, f"{device}: channel power peaks at 37")
    return audio_snr_db(tone[512:], audio[37][512:], trim=128)


def phase_ch_audio(dev, blocks: int = 2) -> None:
    wide, tone = _am_tone(CH_M, blocks * CH_T // CH_M, 61_440_000.0)
    card = _ch_snr(dev, wide, tone, blocks)
    cpu = _ch_snr("cpu", wide, tone, blocks)
    print(f"[ch-audio] AM @ channel 37: SNR card {card:.2f} dB, cpu {cpu:.2f} dB, "
          f"delta {card - cpu:+.3f} dB")
    check(abs(card - cpu) <= SNR_TOL_DB, "channelizer AM SNR card vs cpu")
    check(card > 15.0, f"channelizer AM SNR {card:.1f} dB")


# --- the runtime and API layer: streaming, checkpoints, the transceiver, CAT, the CLI --------

ROOT = Path(__file__).resolve().parent
STREAM_BLOCKS = 8
# the earlier path's host ms a block, read on an H100 at 700 W (PERF.md §5)
EARLIER_HOST_MS = {"Radio.process": 29.85, "Monitor.process": 40.98}


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(_tree_equal, a, b))
    return torch.equal(a, b)


def _flag_blocks(rng, blocks: int) -> list:
    return [(rng.standard_normal((C_FLAG, T_FLAG), np.float32)
             + 1j * rng.standard_normal((C_FLAG, T_FLAG), np.float32)).astype(np.complex64)
            for _ in range(blocks)]


def _flag_controls(dev):
    words = _dev(nco.freq_word(np.linspace(-5e5, 5e5, C_FLAG), FS_IN), dev)
    return words, _dev((np.arange(C_FLAG) % 4).astype(np.int32), dev)


def phase_stream(dev) -> int:
    """BlockStream at the flagship (C=128, T=131072, K1) over STREAM_BLOCKS
    numpy blocks (pinned staging, the copy of block k+1 on a side stream
    during the step of block k) against a loop of chain.step over the same
    blocks on the card: audio and state bit-equal. Then int16 words through
    CaptureSource(raw_i16=True) (the native ring) -> BlockStream ->
    step_i16 against step_i16 on the same words: bit-equal, no overrun.
    K1's count set to 0 just before each streamed run and read just after.
    Returns K1's launches."""
    check(native.HAVE_NATIVE, "the native IQ transport did not build")
    words, modes = _flag_controls(dev)
    rng = np.random.default_rng(SEED + 50)
    blocks = _flag_blocks(rng, STREAM_BLOCKS)
    chain = RxChain(flagship_config()).to(dev)
    chain.fused.launches = 0
    bs = BlockStream(chain.step, chain.init_state(), device=dev)
    outs, _ = bs.run(iter(blocks), words, modes)
    launches = chain.fused.launches
    _check_replayed("stream", bs.compiled, STREAM_BLOCKS, {"K1": launches})
    st = chain.init_state()
    with torch.no_grad():
        for blk, (x, a) in enumerate(zip(blocks, outs)):
            st, a_ref, _ = chain.step(st, _dev(x, dev), words, modes)
            check(torch.equal(a, a_ref), f"stream block {blk}: audio differs from the loop")
    check(_tree_equal(bs.state, st), "stream: the state differs from the loop's")
    print(f"[stream] BlockStream over {STREAM_BLOCKS} flagship blocks: audio and state "
          f"bit-equal to a loop of RxChain.step; K1 launches {launches}")

    chain16 = RxChain(dataclasses.replace(flagship_config(), int16_ingest=True)).to(dev)
    pcm = [np.clip(np.round(rng.standard_normal((C_FLAG, T_FLAG, 2)) * 8000.0), -32768, 32767)
           .astype(np.int16) for _ in range(STREAM_BLOCKS)]
    src = CaptureSource((p.ravel() for p in pcm), block_len=T_FLAG, channels=C_FLAG,
                        capacity_blocks=3, overrun_retries=4000, raw_i16=True)
    chain16.fused.launches = 0
    t0 = time.perf_counter()
    bs16 = BlockStream(lambda st, b, w, m: chain16.step_i16(st, b[0], b[1], w, m),
                       chain16.init_state(), device=dev)
    outs16, _ = bs16.run(src, words, modes)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / STREAM_BLOCKS
    n16 = chain16.fused.launches
    check(len(outs16) == STREAM_BLOCKS and src.overruns == 0,
          f"capture: {len(outs16)} blocks, {src.overruns} overruns")
    _check_replayed("stream int16", bs16.compiled, STREAM_BLOCKS, {"K1": n16})
    st = chain16.init_state()
    with torch.no_grad():
        for blk, (p, a) in enumerate(zip(pcm, outs16)):
            st, a_ref, _ = chain16.step_i16(st, _dev(p[..., 0], dev), _dev(p[..., 1], dev),
                                            words, modes)
            check(torch.equal(a, a_ref), f"capture block {blk}: audio differs from step_i16")
    print(f"[stream] CaptureSource(raw_i16) -> BlockStream -> step_i16 over {STREAM_BLOCKS} "
          f"blocks of {C_FLAG}x{T_FLAG} int16 words: bit-equal to step_i16, 0 overruns, "
          f"{ms:.2f} ms a block (host clock, capture thread included); K1 launches {n16}")
    return launches + n16


def phase_checkpoint(dev) -> dict:
    """Radio (flagship, K1) and Monitor (channelizer_61m44(4096), K5) run 2
    blocks, save, run 2 more; a fresh object loads the checkpoint and runs
    the same 2 blocks: bit-equal audio (and waterfall, channel power).
    Returns the launches of K1 and K5 in these runs."""
    rng = np.random.default_rng(SEED + 51)
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        blocks = _flag_blocks(rng, 4)
        r = Radio(flagship_config(), device=dev)
        for ch, f in enumerate(np.linspace(-5e5, 5e5, C_FLAG)):
            r.tune(ch, float(f))
            r.set_mode(ch, ("ssb", "cw", "am", "nfm")[ch % 4])
        r.chain.fused.launches = 0
        r.process(blocks[0])
        r.process(blocks[1])
        r.save(os.path.join(d, "radio"), epoch=2)
        want = [(r.process(b), r.metrics()["power_in"]) for b in blocks[2:]]
        r2 = Radio(flagship_config(), device=dev)
        r2.chain.fused.launches = 0
        check(r2.load(os.path.join(d, "radio")) == 2, "Radio.load: epoch")
        got = [(r2.process(b), r2.metrics()["power_in"]) for b in blocks[2:]]
        launches["fused_frontend2"] = r.chain.fused.launches + r2.chain.fused.launches
        for blk, ((a, p), (a2, p2)) in enumerate(zip(want, got)):
            check(np.array_equal(a, a2) and np.array_equal(p, p2),
                  f"Radio resume block {blk}: not bit-equal")
        print(f"[checkpoint] Radio (flagship, K1): 2 blocks resumed from epoch 2 bit-equal "
              f"(audio, power_in); K1 launches {launches['fused_frontend2']}")

        cfg = presets.channelizer_61m44(CH_M)
        modes = np.arange(CH_M) % 4
        wide = []
        for _ in range(4):
            x = _wideband(rng, CH_T, CH_M, modes)
            wide.append((x[0] + 1j * x[1]).astype(np.complex64))
        mons = []
        for _ in range(2):
            m = Monitor(cfg, device=dev)
            m.chain.one_kernel.launches = 0
            mons.append(m)
        m, m2 = mons
        for c in range(CH_M):
            m.set_mode(c, CH_NAMES[modes[c]])
        m.process(wide[0])
        m.process(wide[1])
        m.save(os.path.join(d, "monitor"), epoch=2)
        want = [(m.process(x), m.waterfall(), m.channel_power()) for x in wide[2:]]
        check(m2.load(os.path.join(d, "monitor")) == 2, "Monitor.load: epoch")
        got = [(m2.process(x), m2.waterfall(), m2.channel_power()) for x in wide[2:]]
        launches["channelizer_one"] = m.chain.one_kernel.launches + m2.chain.one_kernel.launches
        for blk, (w, g) in enumerate(zip(want, got)):
            check(all(np.array_equal(a, b) for a, b in zip(w, g)),
                  f"Monitor resume block {blk}: not bit-equal")
        print(f"[checkpoint] Monitor (channelizer_61m44({CH_M}), K5): 2 blocks resumed from "
              f"epoch 2 bit-equal (audio, waterfall, channel power); K5 launches "
              f"{launches['channelizer_one']}")
    return launches


def _transceiver(dev) -> Transceiver:
    """The duplex configuration (flagship RX through K1, FIR(4) + CIC(8, 4)
    TX) at C=128 with VFO B on every other channel's split, RIT, XIT, VFO B
    on receive and SAM channels (sent as AM)."""
    trx = Transceiver(*duplex_configs(C_FLAG), device=dev)
    for ch, f in enumerate(np.linspace(-5e5, 5e5, C_FLAG)):
        trx.tune(ch, float(f))
        trx.vfo_b(ch, float(f) + 1000.0)
        trx.split(ch, ch % 2 == 0)
        trx.rit(ch, -150.0 if ch % 3 == 0 else 0.0)
        trx.xit(ch, 75.0 if ch % 5 == 0 else 0.0)
        trx.select_rx_vfo(ch, ch % 7 == 0)
        trx.set_mode(ch, "sam" if ch % 16 == 5 else ("ssb", "cw", "am", "nfm")[ch % 4])
    return trx


def _cat_live(trx: Transceiver, x: np.ndarray, a: np.ndarray) -> None:
    """CatTcpServer over a stream of blocks on the card: FA/MD, TX and RX
    from a TCP client each take effect by the block after the response (or,
    for TX/RX, which answer nothing, after the PTT flag flips)."""
    srv = CatTcpServer(CatServer(trx, channel=0))
    log, errors, stop = [], [], threading.Event()

    def stream():
        try:
            while not stop.is_set():
                with srv.lock:  # a command never half-applies to a block
                    w = trx.step_inputs()
                    ptt = trx.transmitting
                    rx_a, tx = trx.process(x, a)
                log.append((int(w[0][0]), int(w[1][0]), ptt, float(np.abs(rx_a[0]).max()),
                            float(np.abs(tx[0]).max())))
        except Exception as e:  # reported below
            errors.append(e)
            stop.set()

    def wait(cond, what, timeout=60.0):
        t0 = time.monotonic()
        while not cond():
            check(not errors, f"CAT stream: {errors}")
            check(time.monotonic() - t0 < timeout, f"CAT: {what} within {timeout:.0f} s")
            time.sleep(0.005)

    th = threading.Thread(target=stream, daemon=True)
    with srv:
        th.start()
        try:
            with socket.create_connection((srv.host, srv.port), timeout=30.0) as cli:
                cli.settimeout(30.0)
                wait(lambda: len(log) >= 2, "two blocks")
                cli.sendall(b"FR0;FA00000250000;MD4;FA;MD;FR;")
                resp = b""
                while not resp.endswith(b"FR0;"):
                    resp += cli.recv(4096)
                n0 = len(log)
                check(resp == b"FA00000250000;MD4;FR0;", f"CAT response {resp!r}")
                word = int(nco.freq_word(np.array([trx.rx_frequency(0)]), FS_IN)[0])
                wait(lambda: len(log) >= n0 + 3, "three blocks after FA/MD")
                check(all(e[0] == word and e[1] == NFM for e in log[n0 + 1:]),
                      "FA/MD took effect by the next block")
                cli.sendall(b"TX;")
                wait(lambda: trx.transmitting, "PTT keyed")
                n1 = len(log)
                wait(lambda: len(log) >= n1 + 3, "three blocks after TX")
                check(all(e[2] and e[3] == 0.0 and e[4] > 0.0 for e in log[n1 + 1:]),
                      "TX took effect by the next block (RX muted, TX IQ live)")
                cli.sendall(b"RX;")
                wait(lambda: not trx.transmitting, "PTT unkeyed")
                n2 = len(log)
                wait(lambda: len(log) >= n2 + 3, "three blocks after RX")
                check(all(not e[2] and e[3] > 0.0 and e[4] == 0.0 for e in log[n2 + 1:]),
                      "RX took effect by the next block")
        finally:
            stop.set()
            th.join(timeout=60.0)
    check(not th.is_alive(), "the CAT stream thread did not stop")
    check(not errors, f"CAT stream: {errors}")
    print(f"[transceiver] CatTcpServer drove a running stream on the card: FA/MD at block "
          f"{n0 + 1}, TX at {n1 + 1}, RX at {n2 + 1} took effect by the next block "
          f"({len(log)} blocks streamed)")


def phase_transceiver(dev, blocks: int = 4) -> int:
    """Transceiver at C=128 (the duplex configuration; split, RIT, XIT, VFO
    B on receive, SAM sent as AM) for 4 blocks with PTT up, down, up, down,
    against DuplexChain.step with the words and modes of trx.step_inputs():
    the live half bit-equal, the muted half zero, the state bit-equal; then
    the CAT-over-TCP drive of a running stream. K1's count set to 0 just
    before the Transceiver's run and read just after. Returns K1's
    launches."""
    trx = _transceiver(dev)
    ref = DuplexChain(*duplex_configs(C_FLAG)).to(dev)
    st = ref.init_state(C_FLAG)
    rng = np.random.default_rng(SEED + 52)
    freqs = np.linspace(-5e5, 5e5, C_FLAG)
    iq = _fm_iq(rng, freqs, (np.arange(C_FLAG) % 4).astype(np.int32), blocks)
    audio = _tx_inputs(rng, C_FLAG, T_FLAG // 32, blocks)
    trx.chain.rx.fused.launches = 0
    outs = []
    for blk, (x, a) in enumerate(zip(iq, audio)):
        trx.ptt(blk % 2 == 1)
        ctl = [_dev(v, dev) for v in trx.step_inputs()]
        outs.append((trx.transmitting, ctl, *trx.process(x, a)))
    launches = trx.chain.rx.fused.launches
    _check_replayed("transceiver", trx._compiled, blocks, {"K1": launches})
    for blk, ((keyed, ctl, rx_a, tx_iq), x, a) in enumerate(zip(outs, iq, audio)):
        with torch.no_grad():
            st, a_r, x_r, _ = ref.step(st, _dev(x, dev), _dev(a, dev), *ctl)
        if keyed:
            ok = not rx_a.any() and np.array_equal(tx_iq, x_r.cpu().numpy())
        else:
            ok = np.array_equal(rx_a, a_r.cpu().numpy()) and not tx_iq.any()
        check(ok, f"transceiver block {blk} (PTT {'down' if keyed else 'up'}): not bit-equal "
                  "to DuplexChain.step")
        print(f"[transceiver] block {blk}, PTT {'keyed' if keyed else 'up'}: "
              f"{'TX IQ' if keyed else 'RX audio'} bit-equal to DuplexChain.step with the "
              f"Transceiver's words, the other half zero")
    check(_tree_equal(trx.state, st), "transceiver: the state differs from DuplexChain's")
    print(f"[transceiver] state bit-equal after {blocks} blocks; K1 launches {launches}")
    trx.ptt(False)
    trx.chain.rx.fused.launches = 0
    _cat_live(trx, iq[0], audio[0])
    return launches + trx.chain.rx.fused.launches


# --- captured steps: each block's step as one CUDA graph ------------------------------------

GRAPH_BLOCKS = 4


def _graph_pair(name: str, step, init, blocks: list, counted: dict) -> tuple[str, dict]:
    """``CompiledStep(step)`` over ``blocks`` (tuples of device inputs; the
    caller changes words or modes from block 2 on: a retune), block 1's
    state assigned back before block 3 (a load), then a steady block (the
    last block's buffers again), against the eager step over the same
    blocks: every output and the state bit-equal, a capture a binding fed
    and none for the steady block, a replay a block, and each kernel of
    ``counted`` (label -> wrapper) launched once a block plus the capture's
    warm-up. Returns a summary and those launches."""
    blocks = blocks + blocks[-1:]
    cs = CompiledStep(step, init(), device=blocks[0][0].device, name=name)
    before = {k: w.launches for k, w in counted.items()}
    got, saved = [], None
    for blk, inputs in enumerate(blocks):
        if blk == 2:
            saved = clone_tree(cs.state)
        elif blk == 3:
            cs.state = saved
        elif blk == len(blocks) - 1:
            steady = cs.captures
        got.append(clone_tree(cs(*inputs)))
    check(cs.captures == steady, f"graphs {name}: the steady block captured again")
    final = clone_tree(cs.state)
    launches = {k: w.launches - before[k] for k, w in counted.items()}
    _check_replayed(f"graphs {name}", cs, len(blocks), launches)
    st, kept = init(), None
    with torch.no_grad():
        for blk, (inputs, g) in enumerate(zip(blocks, got)):
            if blk == 2:
                kept = st
            elif blk == 3:
                st = kept
            st, *want = step(st, *inputs)
            check(_tree_equal(g, tuple(want)),
                  f"graphs {name} block {blk}: the replayed graph differs from the eager step")
    check(_tree_equal(final, st), f"graphs {name}: the state differs from the eager step's")
    return (f"{len(blocks)} blocks (a retune, a load, a steady block) bit-equal to the eager "
            f"step; bindings fed {len(cs.fed)}, captures "
            f"{cs.captures}, replays {cs.replays}; launches "
            + (", ".join(f"{k} {n}" for k, n in launches.items()) or "(no kernel)")), launches


def _graph_chains(dev) -> dict:
    """name -> (step, init, blocks, counted) for the chain steps the APIs
    capture: the K1 chain, the K2 + K6 slice, TxChain at tx_adc_r1280,
    DuplexChain, ChannelizerChain through K5 and through K3 -> K4."""
    rng = np.random.default_rng(SEED + 60)
    iq = _flag_blocks(rng, GRAPH_BLOCKS)
    words, modes = _flag_controls(dev)
    retuned = _dev(nco.freq_word(np.linspace(-4e5, 6e5, C_FLAG), FS_IN), dev)
    rx = [(_dev(x, dev), words if b < 2 else retuned, modes) for b, x in enumerate(iq)]
    cases = {}
    for name, cfg in (("K1 chain", flagship_config()), ("K2 + K6 slice", slice_config())):
        chain = RxChain(cfg).to(dev)
        counted = {"K1": chain.fused} if name == "K1 chain" else {
            "K2": chain.fused, "K6": chain.backend_kernel}
        cases[name] = (chain.step, chain.init_state, rx, counted)
    tx = TxChain(tx_config(TX_C)).to(dev)
    tw = _dev(nco.freq_word(np.linspace(-20e6, 20e6, TX_C), 61.44e6), dev)
    tw2 = _dev(nco.freq_word(np.linspace(-19e6, 21e6, TX_C), 61.44e6), dev)
    tm = _dev((np.arange(TX_C) % 5).astype(np.int32), dev)
    cases["TxChain (tx_adc_r1280)"] = (
        tx.step, tx.init_state,
        [(_dev(a, dev), tw if b < 2 else tw2, tm)
         for b, a in enumerate(_tx_inputs(rng, TX_C, 512, GRAPH_BLOCKS))], {})
    dpx = DuplexChain(*duplex_configs(C_FLAG)).to(dev)
    d_iq, d_audio, rxw, rxm, txw, txm = _duplex_inputs(C_FLAG)
    rxw2 = nco.freq_word(np.linspace(-4e5, 6e5, C_FLAG), FS_IN)
    cases["DuplexChain"] = (
        dpx.step, dpx.init_state,
        [tuple(_dev(v, dev) for v in (x, a, rxw if b < 2 else rxw2, rxm, txw, txm))
         for b, (x, a) in enumerate(zip(d_iq, d_audio))], {"K1": dpx.rx.fused})
    cfg = presets.channelizer_61m44(CH_M)
    cmodes = np.arange(CH_M) % 4
    mode_a = _dev(cmodes.astype(np.int32), dev)
    mode_b = _dev(((cmodes + 1) % 4).astype(np.int32), dev)
    wide = []
    for b in range(GRAPH_BLOCKS):
        x = _wideband(rng, CH_T, CH_M, cmodes)
        wide.append((_dev((x[0] + 1j * x[1]).astype(np.complex64), dev),
                     mode_a if b < 2 else mode_b))
    one = ChannelizerChain(cfg).to(dev)
    two = ChannelizerChain(dataclasses.replace(cfg, fuse_single_pass=False)).to(dev)
    cases["ChannelizerChain K5"] = (one.step, one.init_state, wide, {"K5": one.one_kernel})
    cases["ChannelizerChain K3 -> K4"] = (two.step, two.init_state, wide,
                                          {"K3": two.pfb, "K4": two.demod_kernel})
    return cases


def _api_graphs(dev, directory: str) -> None:
    """Radio, Monitor, Transceiver and BlockStream over GRAPH_BLOCKS blocks
    with a tune and a mode change before block 2 (PTT keyed from block 2 on
    the Transceiver) and block 2's state saved and loaded back before block
    3 (Radio.save/load, Monitor.save/load, the Transceiver's and the
    stream's ``state``), each against its chain's eager step with the same
    words, modes and state: bit-equal, one capture, a replay a block."""
    rng = np.random.default_rng(SEED + 61)
    iq = _flag_blocks(rng, GRAPH_BLOCKS)
    r = Radio(flagship_config(), device=dev)
    trx = _transceiver(dev)
    for ch, f in enumerate(np.linspace(-5e5, 5e5, C_FLAG)):
        r.tune(ch, float(f))
        r.set_mode(ch, ("ssb", "cw", "am", "nfm")[ch % 4])
    audio = _tx_inputs(rng, C_FLAG, T_FLAG // 32, GRAPH_BLOCKS)
    cfg = presets.channelizer_61m44(CH_M)
    cmodes = np.arange(CH_M) % 4
    mon = Monitor(cfg, device=dev)
    mon.set_mode_all("am")
    wide = []
    for _ in range(GRAPH_BLOCKS):
        x = _wideband(rng, CH_T, CH_M, cmodes)
        wide.append((x[0] + 1j * x[1]).astype(np.complex64))
    words, modes = _flag_controls(dev)
    bs = BlockStream(r.chain.step, r.chain.init_state(), device=dev, donate=False)
    refs = {"Radio": r.chain.init_state(), "Monitor": mon.chain.init_state(),
            "Transceiver": trx.chain.init_state(C_FLAG), "BlockStream": r.chain.init_state()}
    kept = kept_refs = None
    for blk in range(GRAPH_BLOCKS):
        if blk == 2:
            r.tune(0, 2.5e5)
            r.set_mode(1, "am")
            mon.set_mode(3, "nfm")
            trx.tune(0, 2.5e5)
            trx.set_mode(1, "nfm")
            trx.ptt(True)
            r.save(os.path.join(directory, "radio"), epoch=2)
            mon.save(os.path.join(directory, "monitor"), epoch=2)
            kept, kept_refs = (trx.state, bs.state), dict(refs)
        elif blk == 3:
            check(r.load(os.path.join(directory, "radio")) == 2, "graphs Radio.load")
            check(mon.load(os.path.join(directory, "monitor")) == 2, "graphs Monitor.load")
            trx.state, bs.state = kept
            refs = kept_refs
        x = iq[blk]
        xd = _dev(x, dev)
        with torch.no_grad():
            refs["Radio"], a_ref, _ = r.chain.step(
                refs["Radio"], xd, _dev(nco.freq_word(r._freqs, FS_IN), dev), _dev(r._modes, dev))
            check(np.array_equal(r.process(x), a_ref.cpu().numpy()),
                  f"graphs Radio block {blk}: differs from RxChain.step")
            refs["Monitor"], a_ref, aux_ref = mon.chain.step(
                refs["Monitor"], _dev(wide[blk], dev), _dev(mon._modes, dev))
            check(np.array_equal(mon.process(wide[blk]), a_ref.cpu().numpy())
                  and torch.equal(mon.last_aux["waterfall"], aux_ref["waterfall"]),
                  f"graphs Monitor block {blk}: differs from ChannelizerChain.step")
            ctl = [_dev(v, dev) for v in trx.step_inputs()]
            refs["Transceiver"], a_ref, x_ref, _ = trx.chain.step(
                refs["Transceiver"], xd, _dev(audio[blk], dev), *ctl)
            rx_a, tx_iq = trx.process(x, audio[blk])
            check(np.array_equal(tx_iq, x_ref.cpu().numpy()) and not rx_a.any()
                  if trx.transmitting else
                  np.array_equal(rx_a, a_ref.cpu().numpy()) and not tx_iq.any(),
                  f"graphs Transceiver block {blk}: differs from DuplexChain.step")
            refs["BlockStream"], a_ref, _ = r.chain.step(refs["BlockStream"], xd, words, modes)
            (a_bs,), _ = bs.run(iter([x]), words, modes)
            check(torch.equal(a_bs, a_ref), f"graphs BlockStream block {blk}: differs from "
                                            "RxChain.step")
    for what, obj in (("Radio", r), ("Monitor", mon), ("Transceiver", trx), ("BlockStream", bs)):
        cs = obj.compiled if what == "BlockStream" else obj._compiled
        _check_replayed(f"graphs {what}", cs, GRAPH_BLOCKS, {})
        check(_tree_equal(obj.state, refs[what]), f"graphs {what}: the state differs")
        controls = {"Monitor": "a mode change, save/load", "Transceiver": "a tune, a mode "
                    "change, PTT, the state put back"}.get(what, "a tune, a mode change, "
                                                          + ("the state put back"
                                                             if what == "BlockStream"
                                                             else "save/load"))
        print(f"[graphs] {what}: {GRAPH_BLOCKS} blocks ({controls}) bit-equal to the eager "
              f"step; captures {cs.captures}, replays {cs.replays}")


def _graph_ring(dev) -> None:
    """Device inputs read in place: a BlockStream of the K1 chain over a
    ring of 4 device blocks visited out of order, bit-equal to the copying
    path (``BIND_CAP`` 0) on the same blocks, one capture a buffer and no
    copy; then a small step fed BIND_CAP + 2 buffers (the last two copied,
    the copying graph captured once), new contents of a bound buffer, a
    previous output and a state leaf (copied), each against the eager
    step."""
    rng = np.random.default_rng(SEED + 62)
    ring = [_dev(x, dev) for x in _flag_blocks(rng, 4)]
    words, modes = _flag_controls(dev)
    order = [0, 2, 1, 3, 2, 0, 3, 1]
    runs, cap = [], compiled.BIND_CAP
    try:
        for bind_cap in (cap, 0):
            compiled.BIND_CAP = bind_cap
            chain = RxChain(flagship_config()).to(dev)
            bs = BlockStream(chain.step, chain.init_state(), device=dev)
            outs, auxs = bs.run((ring[i] for i in order), words, modes)
            runs.append((bs.compiled, outs, auxs, clone_tree(bs.state)))
    finally:
        compiled.BIND_CAP = cap
    (cs, outs, auxs, st), (ref, outs_ref, auxs_ref, st_ref) = runs
    check((cs.binds, cs.captures, cs.copies) == (4, 4, 0) and ref.copies == 3 * len(order)
          and ref.captures == 1, f"ring: binds {cs.binds}, captures {cs.captures}, copies "
          f"{cs.copies}; copying path: captures {ref.captures}, copies {ref.copies}")
    check(_tree_equal((tuple(outs), tuple(auxs), st), (tuple(outs_ref), tuple(auxs_ref), st_ref)),
          "ring: the bound graphs differ from the copying path")

    def step(state, x):
        return {"acc": state["acc"] * 0.5 + x}, x * 2.0 + state["acc"]

    bufs = [torch.full((4096,), float(i), device=dev) for i in range(cap + 2)]
    cs = CompiledStep(step, {"acc": torch.zeros(4096, device=dev)}, device=dev)
    acc = torch.zeros(4096, device=dev)

    def one(x, what):
        nonlocal acc
        fed = x.clone()
        (out,) = cs(x)
        want = fed * 2.0 + acc
        acc = acc * 0.5 + fed
        check(torch.equal(out, want), f"ring: {what} differs from the eager step")
        return out

    for i, b in enumerate(bufs):
        one(b, f"buffer {i}")
    bufs[0].fill_(-3.0)
    out = one(bufs[0], "a bound buffer's new contents")
    out = one(out, "a previous output")
    one(cs.state["acc"], "a state leaf")
    check((cs.binds, cs.captures, cs.copies) == (cap, cap + 1, 4),
          f"ring: beyond the cap binds {cs.binds}, captures {cs.captures}, copies {cs.copies}")
    check(torch.equal(cs.state["acc"], acc), "ring: the state differs from the eager step's")
    print(f"[graphs] ring: 4 device blocks out of order, {len(order)} blocks bit-equal to the "
          f"copying path, 4 bindings and no copy; beyond the cap and the step's own memory "
          f"copied ({cs.copies} copies, {cs.captures} captures)")


def _api_retunes(dev) -> None:
    """Radio and Monitor over BIND_CAP + 2 blocks, each after a retune
    (``Radio.tune``, ``Monitor.set_mode``), then 2 steady blocks, each against
    its chain's eager step: bit-equal; the words and the modes are rewritten
    in place and the staged block lands in the buffer it was freed from, so
    each keeps one binding (one capture) and copies no input."""
    n, steady = compiled.BIND_CAP + 2, 2
    rng = np.random.default_rng(SEED + 63)
    iq = _flag_blocks(rng, 2)
    r = Radio(flagship_config(), device=dev)
    for ch, f in enumerate(np.linspace(-5e5, 5e5, C_FLAG)):
        r.tune(ch, float(f))
        r.set_mode(ch, ("ssb", "cw", "am", "nfm")[ch % 4])
    cfg = presets.channelizer_61m44(CH_M)
    mon = Monitor(cfg, device=dev)
    mon.set_mode_all("am")
    cmodes = np.arange(CH_M) % 4
    wide = [(x[0] + 1j * x[1]).astype(np.complex64)
            for x in (_wideband(rng, CH_T, CH_M, cmodes) for _ in range(2))]
    st_r, st_m = r.chain.init_state(C_FLAG), mon.chain.init_state()
    for blk in range(n + steady):
        if blk < n:
            r.tune(blk % C_FLAG, 1.0e4 * (blk + 1))
            mon.set_mode(blk, CH_NAMES[(blk + 1) % 4])
        x, w = iq[blk % 2], wide[blk % 2]
        with torch.no_grad():
            st_r, a_ref, _ = r.chain.step(st_r, _dev(x, dev),
                                          _dev(nco.freq_word(r._freqs, FS_IN), dev),
                                          _dev(r._modes, dev))
            check(np.array_equal(r.process(x), a_ref.cpu().numpy()),
                  f"retunes Radio block {blk}: differs from RxChain.step")
            st_m, a_ref, _ = mon.chain.step(st_m, _dev(w, dev), _dev(mon._modes, dev))
            check(np.array_equal(mon.process(w), a_ref.cpu().numpy()),
                  f"retunes Monitor block {blk}: differs from ChannelizerChain.step")
    summary = []
    for what, cs in (("Radio", r._compiled), ("Monitor", mon._compiled)):
        _check_replayed(f"retunes {what}", cs, n + steady, {})
        check(cs.captures == 1 and cs.copies == 0,
              f"retunes {what}: {cs.captures} captures, {cs.copies} inputs copied, not 1 and 0")
        summary.append(f"{what} bindings fed {len(cs.fed)}, captures {cs.captures}, "
                       f"copies {cs.copies}")
    check(_tree_equal(r.state, st_r) and _tree_equal(mon.state, st_m),
          "retunes: the state differs from the eager step's")
    print(f"[graphs] retunes: {n} blocks each after a retune, then {steady} steady, bit-equal "
          f"to the eager step; " + "; ".join(summary))


def _bind_capture_ms(dev) -> None:
    """Host wall time of a new binding (its capture, without the warm-up,
    and one replay) at the benchmark cells' sizes, the flagship's K1 chain
    and the channelizer through K5: the signature's first call, a replay,
    then 3 calls on new buffers, each less the replay's median, against a
    block's air time."""
    rng = np.random.default_rng(SEED + 64)
    words, modes = _flag_controls(dev)
    rx = RxChain(flagship_config()).to(dev)
    cfg = presets.channelizer_61m44(CH_M)
    one = ChannelizerChain(cfg).to(dev)
    cm = _dev((np.arange(CH_M) % 4).astype(np.int32), dev)
    cases = (("flagship_rx", rx, [(_dev(x, dev), words, modes) for x in _flag_blocks(rng, 4)],
              T_FLAG / FS_IN),
             ("channelizer_4096", one,
              [(torch.randn(CH_T, dtype=torch.complex64, device=dev), cm) for _ in range(4)],
              CH_T / cfg.fs_in))

    def timed(fn) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        return 1e3 * (time.perf_counter() - t0)

    for name, chain, blocks, air in cases:
        cs = CompiledStep(chain.step, chain.init_state(), device=dev, name=name)
        first = timed(lambda: cs(*blocks[0]))
        replay = statistics.median(timed(lambda: cs(*blocks[0])) for _ in range(5))
        bind = [timed(lambda b=b: cs(*b)) - replay for b in blocks[1:]]
        check(cs.captures == 4 and cs.binds == 4, f"{name}: {cs.captures} captures, "
                                                  f"{cs.binds} bindings for 4 buffers")
        print(f"[graphs] {name}: a new binding {statistics.median(bind):.2f} ms (3 buffers: "
              + ", ".join(f"{b:.2f}" for b in bind) + f"; a replay {replay:.3f} ms taken off); "
              f"the signature's first call, warm-up included, {first:.1f} ms; a block's air "
              f"time {1e3 * air:.2f} ms")


def phase_graphs(dev) -> dict:
    """Each chain step the APIs capture, as CompiledStep and eagerly, on the
    same seeded inputs (_graph_chains, _graph_pair), then device inputs read
    in place (_graph_ring, _api_retunes, _bind_capture_ms) and the API sites
    (_api_graphs). Returns each kernel's launches in the captured runs."""
    _record_bindings()
    _graph_ring(dev)
    _api_retunes(dev)
    _bind_capture_ms(dev)
    launches = {}
    names = {"K1": "fused_frontend2", "K2": "fused_frontend", "K6": "ols_demod",
             "K5": "channelizer_one", "K3": "pfb_dft", "K4": "demod_agc"}
    for name, (step, init, blocks, counted) in _graph_chains(dev).items():
        summary, n = _graph_pair(name, step, init, blocks, counted)
        print(f"[graphs] {name}: {summary}")
        for k, v in n.items():
            launches[names[k]] = launches.get(names[k], 0) + v
    with tempfile.TemporaryDirectory() as d:
        _api_graphs(dev, d)
    return launches


def _python(*args) -> subprocess.CompletedProcess:
    """``python *args`` from the checkout's root, the root on PYTHONPATH."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), *filter(None, [os.environ.get("PYTHONPATH")])]))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)


def _cli(*args) -> subprocess.CompletedProcess:
    return _python("-m", "radioframe_torch.cli", *args)


def _example(name: str, *args) -> subprocess.CompletedProcess:
    return _python(str(ROOT / "examples" / f"{name}.py"), *args)


def phase_cli(dev) -> None:
    """``python -m radioframe_torch.cli rx`` on an SSB capture WAV (1.536
    Msps, the flagship plan through K1) on the card and with --device cpu:
    both exit 0, the card's SNR above 20 dB and within 1 dB of the CPU's;
    ``cli monitor --channels 4096`` on one block of 8,388,608 samples with an
    AM tone at channel 37: exit 0, channel 37 the strongest; ``cli info``
    with its FT8/WSPR lines; the four examples added with the digital modes
    (channelizer, duplex, golden RX, monitor) with ``--device cuda`` at
    their default sizes, four at a time, the channelizer's waterfall a PNG."""
    with tempfile.TemporaryDirectory() as d:
        iq, truth = FX.ssb_capture(FS_IN, 4 * T_FLAG, 100_000.0)
        cap = os.path.join(d, "ssb.wav")
        write_wav(cap, iq, FS_IN)
        snr = {}
        for where, device in (("card", str(dev)), ("cpu", "cpu")):
            out = os.path.join(d, f"audio_{where}.wav")
            p = _cli("rx", "--wav", cap, "--freq", "100000", "--mode", "ssb", "--out", out,
                     "--device", device)
            check(p.returncode == 0, f"cli rx --device {device}: exit {p.returncode}\n"
                                     f"{p.stderr[-3000:]}")
            audio, _ = read_wav(out)
            snr[where] = audio_snr_db(truth[: len(audio)], audio)
            print(f"[cli] rx --device {device}: exit 0, SNR {snr[where]:.2f} dB; "
                  f"{p.stdout.splitlines()[0]}")
        check(snr["card"] > 20.0 and abs(snr["card"] - snr["cpu"]) <= SNR_TOL_DB,
              f"cli rx SNR card {snr['card']:.2f} vs cpu {snr['cpu']:.2f} dB")
        wide, _ = _am_tone(CH_M, CH_T // CH_M, 61_440_000.0)
        wav = os.path.join(d, "wide.wav")
        write_wav(wav, wide, 61_440_000.0)
        p = _cli("monitor", "--wav", wav, "--channels", str(CH_M), "--mode", "am",
                 "--channel", "37", "--audio-out", os.path.join(d, "ch37.wav"),
                 "--device", str(dev))
        check(p.returncode == 0, f"cli monitor: exit {p.returncode}\n{p.stderr[-3000:]}")
        lines = p.stdout.splitlines()
        check(lines[1].split()[1] == "37", f"cli monitor: strongest channel {lines[1]!r}")
        print(f"[cli] monitor --channels {CH_M}: exit 0; {lines[0]}; {lines[1].strip()}")
        p = _cli("info", "--device", str(dev))
        check(p.returncode == 0 and all(any(ln.startswith(f"{m}:") for ln in p.stdout.splitlines())
                                        for m in ("FT8", "WSPR")),
              f"cli info: exit {p.returncode}\n{p.stdout}{p.stderr[-2000:]}")
        print("[cli] info: " + " | ".join(p.stdout.splitlines()))
        examples = {"torch_channelizer_demo": ["--out", os.path.join(d, "waterfall.png")],
                    "torch_duplex_demo": [], "torch_golden_rx_demo": [],
                    "torch_monitor_demo": []}
        with ThreadPoolExecutor(max_workers=4) as pool:
            runs = dict(zip(examples, pool.map(lambda kv: _example(kv[0], *kv[1], "--device",
                                                                     str(dev)), examples.items())))
        for name, p in runs.items():
            check(p.returncode == 0, f"examples/{name}.py --device {dev}: exit {p.returncode}\n"
                                     f"{p.stdout[-2000:]}{p.stderr[-3000:]}")
            print(f"[cli] examples/{name}.py --device {dev}: exit 0; "
                  + " | ".join(ln.strip() for ln in p.stdout.splitlines()[-5:]))
        check(Path(d, "waterfall.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n",
              "channelizer demo: no PNG written")


TRACE_BLOCKS = 2
TRACE_KERNELS = {"fused_frontend2": "fused_frontend2_kernel",
                 "fused_frontend": "fused_frontend_kernel", "ols_demod": "ols_demod_kernel",
                 "channelizer_one": "channelizer_one_kernel"}  # -> the __global__ function
TRACE_TOP = 6


def phase_trace(dev, card: str) -> dict:
    """Inside one ``diag.timing.trace`` on the card: two blocks each of the
    flagship Radio (K1), the slice Radio (K2 + K6) and the single-pass
    Monitor on channelizer_61m44(4096) (K5). The written
    ``plugins/profile/*/<host>.trace.json.gz`` is read back: each of K1, K2,
    K6 and K5 must appear by its ``__global__`` name among the events whose
    ``cat`` is ``kernel``; the device events with the most summed time are
    printed beside the card. Returns each kernel's launches in the run."""
    names = ("ssb", "cw", "am", "nfm")
    freqs = np.linspace(-5e5, 5e5, C_FLAG)
    radios = {"flagship": Radio(flagship_config(), device=dev),
              "slice": Radio(slice_config(), device=dev)}
    for radio in radios.values():
        for ch, f in enumerate(freqs):
            radio.tune(ch, float(f))
            radio.set_mode(ch, names[ch % 4])
    mon = Monitor(presets.channelizer_61m44(CH_M), device=dev)
    ch_modes = np.arange(CH_M) % 4
    for c in range(CH_M):
        mon.set_mode(c, CH_NAMES[ch_modes[c]])
    rng = np.random.default_rng(SEED + 13)
    iq = [_slice_iq(rng, freqs, radios["slice"]._modes, b) for b in range(TRACE_BLOCKS)]
    wide = []
    for _ in range(TRACE_BLOCKS):
        x = _wideband(rng, CH_T, CH_M, ch_modes)
        wide.append((x[0] + 1j * x[1]).astype(np.complex64))
    kern = {"fused_frontend2": radios["flagship"].chain.fused,
            "fused_frontend": radios["slice"].chain.fused,
            "ols_demod": radios["slice"].chain.backend_kernel,
            "channelizer_one": mon.chain.one_kernel}
    for k in kern.values():
        k.launches = 0
    kern["fused_frontend"].variant_launches = dict.fromkeys(VARIANTS, 0)
    with tempfile.TemporaryDirectory() as d:
        with timing.trace(d, device=dev) as log_dir:
            out = [(radio.process(x), (C_FLAG, T_FLAG // radio.config.decim))
                   for x in iq for radio in radios.values()]
            out += [(mon.process(x), (CH_M, CH_T // CH_M)) for x in wide]
        files = list(Path(log_dir).glob("plugins/profile/*/*.trace.json.gz"))
        check(len(files) == 1, f"trace: {len(files)} trace files under {log_dir}")
        with gzip.open(files[0], "rt") as f:
            events = json.load(f)["traceEvents"]
        rel = files[0].relative_to(log_dir)
    for a, shape in out:
        check(a.shape == shape and bool(np.isfinite(a).all()),
              f"trace: audio shape {a.shape} (want {shape}) / finite")
    launches = {k: kern[k].launches for k in TRACE_KERNELS}
    launches["fused_frontend_variants"] = kern["fused_frontend"].variant_launches["full"]
    for what, obj, ks in (("flagship", radios["flagship"], ("fused_frontend2",)),
                          ("slice", radios["slice"], ("fused_frontend", "ols_demod",
                                                      "fused_frontend_variants")),
                          ("monitor", mon, ("channelizer_one",))):
        _check_replayed(f"trace {what}", obj._compiled, TRACE_BLOCKS, {k: launches[k] for k in ks})
    kernel_names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    for k, g in TRACE_KERNELS.items():
        check(any(re.search(rf"\b{g}\b", n) for n in kernel_names),
              f"trace: no kernel event names {g} ({k}); kernels traced: {sorted(kernel_names)}")
    by_name = {}  # name -> the device events of that name
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_name.setdefault(e["name"], []).append(e)
    print(f"[trace] {rel}: {len(events)} events, {len(kernel_names)} kernel names; "
          f"{', '.join(TRACE_KERNELS.values())} found; launches {launches} ({card})")
    summed = {n: sum(float(e.get("dur", 0.0)) for e in es) for n, es in by_name.items()}
    for name in sorted(summed, key=summed.get, reverse=True)[:TRACE_TOP]:
        es = by_name[name]
        longest = max(es, key=lambda e: float(e.get("dur", 0.0)))
        nbytes = [e.get("args", {}).get("bytes") for e in es]
        moved = (f", {sum(nbytes) / 1e6:.3f} MB, the longest {longest['dur'] / 1e3:.4f} ms for "
                 f"{longest['args']['bytes'] / 1e6:.3f} MB" if None not in nbytes else "")
        print(f"[trace]   {name[:70]}: {summed[name] / 1e3:.4f} ms summed, {len(es)} events"
              f"{moved} ({card})")
    return launches


def _eager_stream(step, state, stager: Stager, blocks, *args):
    """BlockStream.run's loop with the eager step in place of the captured
    one (the path before CompiledStep): block k+1 staged while block k
    steps, each output copied to the host."""
    outs, st = [], [state]
    nxt = stager.stage(blocks[0])
    with torch.no_grad():
        for k in range(len(blocks)):
            cur = stager.take(nxt)
            st[0], out, _ = step(st[0], cur, *args)
            if k + 1 < len(blocks):
                nxt = stager.stage(blocks[k + 1])
            outs.append(stager.to_host(out))
    return outs


def _eager_api(chain, stager: Stager, block, *args):
    """``process``'s path with the eager step (before CompiledStep): stage
    the block, step, copy the audio to the host."""
    st = [chain.init_state()]

    def run():
        x = stager.to_device(block, np.complex64)
        with torch.no_grad():
            st[0], a, _ = chain.step(st[0], x, *args)
        return stager.to_host(a)
    return run


def phase_api_time(dev, label: str) -> None:
    """Host ms per block (host clock, numpy in and numpy out) of
    Radio.process at the flagship (K1) and Monitor.process on
    channelizer_61m44(4096) (K5) through their pinned staging, and of
    BlockStream.run per block over STREAM_BLOCKS copies of the same block,
    its outputs copied to the host as the APIs copy theirs
    (``Stager.to_host``): each through its CUDA graph and with the eager
    step in its place, in turns (_turns_ms); beside them the same steps
    behind the earlier pageable copies (and, for Monitor, numpy's split into
    float32 planes), re-created here."""
    rng = np.random.default_rng(SEED + 53)
    block = _flag_blocks(rng, 1)[0]
    words, modes = _flag_controls(dev)
    cfg = flagship_config()
    chain = RxChain(cfg).to(dev)
    radio = Radio(cfg, device=dev)
    for ch, f in enumerate(np.linspace(-5e5, 5e5, C_FLAG)):
        radio.tune(ch, float(f))
        radio.set_mode(ch, ("ssb", "cw", "am", "nfm")[ch % 4])
    st = [chain.init_state()]

    def pageable_radio():
        x = torch.from_numpy(np.ascontiguousarray(block, np.complex64)).to(dev)
        with torch.no_grad():
            st[0], a, _ = chain.step(st[0], x, words, modes)
        return a.cpu().numpy()

    def stream(step, state, blk, *args):
        bs = BlockStream(step, state, device=dev)
        return lambda: [bs.stager.to_host(o) for o in
                        bs.run(iter([blk] * STREAM_BLOCKS), *args)[0]]

    def eager_stream(step, state, blk, *args):
        return lambda: _eager_stream(step, state, Stager(dev), [blk] * STREAM_BLOCKS, *args)

    ccfg = presets.channelizer_61m44(CH_M)
    cmodes = np.arange(CH_M) % 4
    x = _wideband(rng, CH_T, CH_M, cmodes)
    wide = (x[0] + 1j * x[1]).astype(np.complex64)
    mon = Monitor(ccfg, device=dev)
    for c in range(CH_M):
        mon.set_mode(c, CH_NAMES[cmodes[c]])
    mode_t = _dev(cmodes.astype(np.int32), dev)
    cst = [mon.chain.init_state()]

    def pageable_monitor():
        wr = torch.from_numpy(np.ascontiguousarray(wide.real, np.float32)).to(dev)
        wi = torch.from_numpy(np.ascontiguousarray(wide.imag, np.float32)).to(dev)
        with torch.no_grad():
            cst[0], a, _ = mon.chain.step_planes(cst[0], wr, wi, mode_t)
        return a.cpu().numpy()

    pairs = {  # what -> (through the CUDA graph, with the eager step), blocks a call
        "Radio.process": (lambda: radio.process(block),
                          _eager_api(chain, Stager(dev), block, words, modes), 1),
        "BlockStream.run (flagship), per block": (
            stream(chain.step, chain.init_state(), block, words, modes),
            eager_stream(chain.step, chain.init_state(), block, words, modes), STREAM_BLOCKS),
        "Monitor.process": (lambda: mon.process(wide),
                            _eager_api(mon.chain, Stager(dev), wide, mode_t), 1),
        "BlockStream.run (channelizer), per block": (
            stream(mon.chain.step, mon.chain.init_state(), wide, mode_t),
            eager_stream(mon.chain.step, mon.chain.init_state(), wide, mode_t), STREAM_BLOCKS)}
    for what, (graph, eager, n) in pairs.items():
        ms = _turns_ms({"graph": graph, "eager": eager})
        earlier = EARLIER_HOST_MS.get(what)
        print(f"[api-time] {what}: CUDA graph {ms['graph'] / n:.4f} ms/block, eager step "
              f"{ms['eager'] / n:.4f} (host clock, medians of 5 in turns after 3 warm-ups; "
              f"{label})" + (f"; the earlier path in PERF.md: {earlier} ms" if earlier else ""))
    for what, fn in (("Radio.process, the earlier pageable copy", pageable_radio),
                     ("Monitor.process, the earlier plane split and pageable copies",
                      pageable_monitor)):
        print(f"[api-time] {what}: {host_ms(fn):.4f} ms/block (host clock, median of 5 after 3 "
              f"warm-ups; {label})")


# --- the pipelined executor, the digital modes ----------------------------------------------

PIPE_BLOCKS = 8
PIPE_WARMUP = 512  # the mode filter's cold start in block 0 (tests/test_pipeline.py's WARMUP)


def _union_ms(trace) -> float:
    """The device's busy time in ms: the union of the activities' intervals
    (two streams' kernels may overlap)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in trace)
    busy, (s0, e0) = 0.0, iv[0]
    for s, e in iv[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    return (busy + e0 - s0) / 1e3


def _turns_ms(fns: dict, rounds: int = 5, warmup: int = 3) -> dict:
    """Host-clock median ms of each of two functions (each ends with a
    synchronize), timed in turns A B B A after ``warmup`` calls of each:
    the host's noise falls on both alike."""
    (a, fa), (b, fb) = fns.items()
    for _ in range(warmup):
        fa()
        fb()
    times = {a: [], b: []}
    for i in range(rounds):
        for name, fn in (((a, fa), (b, fb)) if i % 2 == 0 else ((b, fb), (a, fa))):
            t0 = time.perf_counter()
            fn()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def _tree_diff(a, b) -> float:
    """The largest |a - b| over two state trees, relative to each leaf's
    scale (at least 1)."""
    if isinstance(a, dict):
        return max((_tree_diff(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, tuple):
        return max((_tree_diff(x, y) for x, y in zip(a, b)), default=0.0)
    d = (a.to(torch.complex128) - b.to(torch.complex128)).abs().max()
    return float(d) / max(1.0, float(b.abs().max()))


def phase_pipeline(dev, label: str) -> dict:
    """PipelinedRx on two streams of the one card over PIPE_BLOCKS blocks, for
    the flagship (K1 front, dense back end) and the slice (K2 front, K6
    back) at C=128, T=131072, modes arange(128) % 4 (a carrier in each NFM
    channel): audio and final state against sequential RxChain.step on the
    card (2e-4 after block 0's warm-up; the same kernels in the same order,
    so bit-equal is expected and reported), the kernels' counts set to 0
    just before the pipelined run and read just after; host-clock ms per
    block pipelined and sequential (median of 5 after 3 warm-ups, timed in
    turns) and the device busy share of each. Returns the launches."""
    rng = np.random.default_rng(SEED + 60)
    freqs = np.linspace(-5e5, 5e5, C_FLAG)
    modes_np = (np.arange(C_FLAG) % 4).astype(np.int32)
    words, modes = _dev(nco.freq_word(freqs, FS_IN), dev), _dev(modes_np, dev)
    blocks = [_dev(_slice_iq(rng, freqs, modes_np, b), dev) for b in range(PIPE_BLOCKS)]
    launches = {}
    for what, cfg in (("flagship", flagship_config()), ("slice", slice_config())):
        chain = RxChain(cfg).to(dev)
        kernels = ({"fused_frontend2": chain.fused} if what == "flagship" else
                   {"fused_frontend": chain.fused, "ols_demod": chain.backend_kernel})
        st = chain.init_state()
        seq = []
        with torch.no_grad():
            for x in blocks:
                st, a, _ = chain.step(st, x, words, modes)
                seq.append(a)
        pipe = PipelinedRx(chain)
        f, b = pipe.init_states(C_FLAG)
        for k in kernels.values():
            k.launches = 0
        f, b, audios, _ = pipe.run(f, b, blocks, words, modes)
        torch.cuda.synchronize()
        n = {name: k.launches for name, k in kernels.items()}
        check(all(v == PIPE_BLOCKS for v in n.values()), f"pipeline {what}: launches {n}")
        for name, v in n.items():
            launches[name] = launches.get(name, 0) + v
        worst, equal = 0.0, True
        for blk, (a, r) in enumerate(zip(audios, seq)):
            d = np.abs(_nfm_mod((a - r).cpu().numpy(), modes_np, FLAG_NFM_PERIOD))
            worst = max(worst, float(d[:, PIPE_WARMUP if blk == 0 else 0:].max()))
            equal = equal and bool(torch.equal(a, r))
        f_ref, b_ref = chain.split_state(st)
        st_err = max(_tree_diff(f, f_ref), _tree_diff(b, b_ref))
        st_equal = _tree_equal(f, f_ref) and _tree_equal(b, b_ref)
        check(worst <= CHAIN_TOL and st_err <= CHAIN_TOL,
              f"pipeline {what}: audio {worst:.3g}, state {st_err:.3g} against the sequential step")

        def seq_run():
            s = chain.init_state()
            with torch.no_grad():
                for x in blocks:
                    s, _, _ = chain.step(s, x, words, modes)
            torch.cuda.synchronize()

        def pipe_run():
            fs, bs = pipe.init_states(C_FLAG)
            pipe.run(fs, bs, blocks, words, modes)
            torch.cuda.synchronize()

        ms = {k: v / PIPE_BLOCKS for k, v in
              _turns_ms({"pipelined": pipe_run, "sequential": seq_run}).items()}
        busy = {k: _union_ms(device_events(fn)) / PIPE_BLOCKS
                for k, fn in (("pipelined", pipe_run), ("sequential", seq_run))}
        print(f"[pipeline] {what} ({', '.join(f'{k} x{v}' for k, v in n.items())}): "
              f"{PIPE_BLOCKS} blocks on two streams; audio max|pipelined - sequential| "
              f"{worst:.3e} after block 0's {PIPE_WARMUP} warm-up samples"
              f"{' (bit-equal)' if equal else ''}; state {st_err:.2e}"
              f"{' (bit-equal)' if st_equal else ''}")
        for k in ("pipelined", "sequential"):
            print(f"[pipeline] {what} {k}: {ms[k]:.4f} ms a block (host clock, median of 5 "
                  f"after 3 warm-ups, {PIPE_BLOCKS}-block runs in turns with the other); device "
                  f"busy {busy[k]:.4f} ms "
                  f"a block, {busy[k] / ms[k]:.1%} of it ({label})")
        print(f"[pipeline] {what}: pipelined / sequential = "
              f"{ms['pipelined'] / ms['sequential']:.3f}")
    return launches


FT8_B = 4096       # one decode cycle of a skimmer behind the 4096-channel Monitor
FT8_ITERS = 40
FT8_SIGMA = 2.0    # tests/test_digital_modes.py's batched decode
FT8_CPU_ROWS = 64
_CALL_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _ft8_messages(rng, n: int) -> list:
    """n seeded type-1 messages: (to, de, grid), standard callsigns."""
    def call():
        a = rng.choice(list(_CALL_LETTERS), 5)
        return f"{a[0]}{a[1]}{rng.integers(0, 10)}{a[2]}{a[3]}{a[4]}"

    out = []
    for _ in range(n):
        grid = (f"{_CALL_LETTERS[rng.integers(0, 18)]}{_CALL_LETTERS[rng.integers(0, 18)]}"
                f"{rng.integers(0, 10)}{rng.integers(0, 10)}")
        out.append(("CQ" if rng.random() < 0.3 else call(), call(), grid))
    return out


def _ft8_audio(tones: np.ndarray, dev, seed: int) -> torch.Tensor:
    """(B, 79) tones -> (B, 79 * 1920) float32 8-FSK at 12 kHz plus noise of
    sigma FT8_SIGMA, made on the card: ft8.modulate's continuous phase (the
    running sum of the instantaneous frequency) in closed form, in float64."""
    f = ft8.FS
    freq = 1000.0 + ft8.TONE_HZ * torch.from_numpy(tones).to(dev, torch.float64)   # (B, 79)
    start = torch.cumsum(freq * ft8.SPS, dim=1) - freq * ft8.SPS                    # before k
    j = torch.arange(1, ft8.SPS + 1, device=dev, dtype=torch.float64)
    phase = (2.0 * np.pi / f) * (start[..., None] + freq[..., None] * j)            # (B, 79, sps)
    audio = torch.sin(phase).reshape(len(tones), -1).to(torch.float32)
    del phase
    g = torch.Generator(device=dev).manual_seed(seed)
    return audio.add_(FT8_SIGMA * torch.randn(audio.shape, generator=g, device=dev))


def _ft8_check_rows(info: np.ndarray, ok: np.ndarray, msgs: list) -> int:
    """How many rows decode with ok, a matching CRC, to their message."""
    good = 0
    for bits, k, msg in zip(info, ok, msgs):
        if k and int("".join(map(str, bits[77:])), 2) == ft8.crc14(bits[:77]):
            try:
                good += ft8.unpack_message(bits[:77]) == msg
            except (ValueError, IndexError):
                pass
    return good


def phase_digital(dev, label: str) -> None:
    """FT8 decode batched over FT8_B = 4096 channel slots (seeded messages at
    12 kHz, noise sigma 2): symbol_energies -> soft_bits -> decode_llrs (40
    min-sum iterations) on the card; every row must decode to its message;
    64 rows held against the port on the CPU (LLRs within 1e-4 of their
    scale, hard bits and ok equal); the decode's CUDA-event ms and device
    activities. Then the FT8 skimmer at tests/test_skimmer.py's shapes (the
    port's PfbChannelizer, M=32, three signals) decoded on the card, a clean
    WSPR round trip (host code) and Radio.capabilities()."""
    rng = np.random.default_rng(SEED + 70)
    msgs = _ft8_messages(rng, FT8_B)
    tones = np.stack([ft8.encode_symbols(*m) for m in msgs])
    audio = _ft8_audio(tones, dev, SEED + 71)
    basis = ft8.tone_basis()
    print(f"[digital] FT8 input: {tuple(audio.shape)} float32, {audio.numel() * 4 / 1e9:.2f} GB "
          f"on the card; min-sum messages {FT8_B} x {ft8.H.shape[0]} x {ft8.H.shape[1]} "
          f"float32, {FT8_B * ft8.H.size * 4 / 1e6:.0f} MB a tensor")

    def decode():
        with torch.no_grad():
            e = ft8.symbol_energies(audio, basis)
            llr = ft8.soft_bits(e)
            info, ok = ft8.decode_llrs(llr, iters=FT8_ITERS)
        return llr, info, ok

    llr, info, ok = decode()
    torch.cuda.synchronize()
    good = _ft8_check_rows(info.cpu().numpy(), ok.cpu().numpy(), msgs)
    check(good == FT8_B, f"FT8: {good} of {FT8_B} rows decoded to their messages")
    x64 = audio[:FT8_CPU_ROWS].cpu()
    e_c = ft8.symbol_energies(x64, basis)
    llr_c = ft8.soft_bits(e_c)
    info_c, ok_c = ft8.decode_llrs(llr_c, iters=FT8_ITERS)
    llr_k = llr[:FT8_CPU_ROWS].cpu()
    l_err = float((llr_k - llr_c).abs().max() / llr_c.abs().max())
    check(l_err <= 1e-4, f"FT8: card LLRs against the CPU's {l_err:.3g} of scale")
    check(torch.equal(info[:FT8_CPU_ROWS].cpu(), info_c) and torch.equal(ok[:FT8_CPU_ROWS].cpu(),
                                                                         ok_c),
          "FT8: card hard bits / ok differ from the CPU's on the same rows")
    ms = median_ms(decode, runs=5, inner=1, warmup=2)
    ms_minsum = median_ms(lambda: ft8.decode_llrs(llr, iters=FT8_ITERS), runs=5, inner=1,
                          warmup=2)
    trace = device_events(decode)
    kernels = [e for e in trace if not e.name.startswith(("Memcpy", "Memset"))]
    busy = _union_ms(trace)
    nbytes = audio.numel() * 4 + FT8_B * (ft8.N_INFO + 1)
    b_ms, b_by = bound(nbytes, 0.0)
    print(f"[digital] FT8 decode of {FT8_B} slots: {good}/{FT8_B} decoded to their messages "
          f"(ok and CRC); {FT8_CPU_ROWS} rows against the CPU: LLRs {l_err:.2e} of scale, "
          "hard bits and ok equal")
    print(f"[digital] FT8 decode: {ms:.4f} ms (CUDA events, median of 5), the min-sum alone "
          f"{ms_minsum:.4f} ms ({ms_minsum / ms:.1%}); {len(kernels)} kernel launches, "
          f"{len(trace)} device activities, device busy {busy:.4f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}: the audio read once) ({label})")

    # the skimmer: wideband -> PFB channelizer -> batched FT8 decode
    M, fs_ch, sps, f0 = 32, 12_000.0, 1920, 1000.0
    sk_msgs = [("CQ", "K1ABC", "FN42"), ("CQ", "W9W", "EM69"), ("K1ABC", "GM4XYZ", "IO87")]
    act = [5, 13, 27]
    g = np.random.default_rng(11)
    base = []
    for m in sk_msgs:
        fr = f0 + 6.25 * ft8.encode_symbols(*m).astype(np.float64)
        base.append(np.exp(1j * 2.0 * np.pi * np.cumsum(np.repeat(fr, sps) / fs_ch))
                    .astype(np.complex64))
    T = len(base[0]) * M
    n = np.arange(T)
    wide = np.zeros(T, np.complex64)
    for c, bb in zip(act, base):
        wide += (np.repeat(bb, M) * np.exp(2j * np.pi * (c / M) * n)).astype(np.complex64)
    wide += (0.05 * (g.standard_normal(T) + 1j * g.standard_normal(T))).astype(np.complex64)
    pfb = PfbChannelizer(M, 8).to(dev)
    with torch.no_grad():
        chans, _ = pfb(pfb.init_state(1), _dev(wide[None, :], dev))
    chans = chans[0]
    batch = chans[act]
    sk_basis = ft8.tone_basis(fs_ch, f0, sps)
    decoded = {}
    for start in range(0, 4 * (pfb.K // 2) + 1, 2):  # the PFB's group delay
        sk_info, sk_ok = ft8.decode_llrs(ft8.soft_bits(ft8.symbol_energies(batch, sk_basis,
                                                                           start, sps)))
        for i, (bits, k) in enumerate(zip(sk_info.cpu().numpy(), sk_ok.cpu().numpy())):
            if i not in decoded and _ft8_check_rows(bits[None], [k], [sk_msgs[i]]):
                decoded[i] = sk_msgs[i]
        if len(decoded) == len(act):
            break
    check(len(decoded) == len(act), f"skimmer: decoded only {sorted(decoded)}")
    peak = ft8.symbol_energies(chans, sk_basis, 0, sps).amax(dim=(1, 2)).cpu().numpy()
    quiet = np.setdiff1d(np.arange(M), act)
    check(peak[act].min() > 20.0 * peak[quiet].max(), "skimmer: quiet channels' energy")
    print(f"[digital] skimmer: {T} wideband samples through the PfbChannelizer (M={M}) on the "
          f"card, {len(act)} of {len(act)} FT8 signals decoded; active/quiet peak energy "
          f"{peak[act].min() / peak[quiet].max():.0f}x")

    sym = wspr.encode_symbols("K1ABC", "FN42", 37)
    got = wspr.decode(wspr.modulate(sym, fs=1500.0, f0=400.0, sps=1024), fs=1500.0, f0=400.0,
                      sps=1024, search_offsets=0)
    check(got == ("K1ABC", "FN42", 37), f"WSPR round trip: {got}")
    caps = Radio(RxConfig(channels=1), device=dev).capabilities()
    check(caps["ft8"] and caps["wspr"], f"capabilities {caps}")
    print(f"[digital] WSPR clean round trip (host code): {got}; Radio.capabilities(): {caps}")


def main() -> None:
    dev = torch.device("cuda")
    _record_bindings()
    name, smi = phase_device()
    phase_build()
    worst = {"fused_frontend2": phase_kernel(dev), "fused_frontend": phase_k2_kernel(dev),
             "fused_frontend_variants": phase_k8(dev), "ols_demod": phase_k6_kernel(dev),
             **phase_ch_kernels(dev)}
    worst["channelizer_one_emit_env"] = phase_emit_env_kernel(dev)
    for k, e in (*phase_shard_shapes(dev).items(), *phase_walk_joins(dev).items()):
        worst[k] = max(worst[k], e)
    phase_channel_major(dev)
    worst["pfb_dft_variants"], k9_times = phase_k9(dev, smi)
    launches = {"fused_frontend2": phase_slice(dev), **phase_rx_slice(dev),
                **phase_ch_slice(dev)}
    phase_tx(dev)
    # K1's count: the flagship's run, then the duplex's and the RX options'
    launches["fused_frontend2"] += phase_duplex(dev) + phase_rx_options(dev)
    # the runtime and API layer: K1 through BlockStream, the capture ring, the
    # checkpointed Radio and the Transceiver; K5 through the checkpointed Monitor
    launches["fused_frontend2"] += phase_stream(dev) + phase_transceiver(dev)
    # every chain step the APIs capture, replayed against its eager step
    for k, n in phase_graphs(dev).items():
        launches[k] += n
    for k, n in phase_checkpoint(dev).items():
        launches[k] += n
    # the pipelined executor: K1, K2 and K6 on two streams
    for k, n in phase_pipeline(dev, smi).items():
        launches[k] += n
    phase_digital(dev, smi)
    phase_cli(dev)
    # diag.timing.trace around K1, K2 + K6 and K5
    for k, n in phase_trace(dev, smi).items():
        launches[k] += n
    worst["halo_dma"], shard_launches, k7_times = phase_sharded(dev, smi)
    for k in ("halo_dma", "channelizer_one_emit_env"):
        launches[k] = shard_launches[k]
    times = {"fused_frontend2": phase_time(dev, smi), **phase_slice_time(dev, smi),
             **phase_ch_time(dev, smi), "pfb_dft_variants": k9_times, "halo_dma": k7_times}
    phase_tx_time(dev, smi)
    phase_api_time(dev, smi)
    phase_parent(dev, smi)
    phase_audio(dev)
    phase_ch_audio(dev)
    phase_loopback(dev)
    for k, n in launches.items():
        check(n > 0, f"{k} was not launched on its path")
    print(f"[card] {smi}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": launches[k],
         "max_abs_err": worst[k], **times[k]} for k, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
