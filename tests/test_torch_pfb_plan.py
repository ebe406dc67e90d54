"""The plan of the channelizer's polyphase stage on the card
(``radioframe_torch/kernels/pfb_plan.py``, ``csrc/channelizer.cuh``
``rf::PfbColumns``): K3's clusters and runs of frames, K9's pfb_only column
blocks, their shared memory within a Hopper block's 227 KB, their refusals,
the input bytes the column walk reads, and both schedules executed in plain
PyTorch (``pfb_plan.execute``), bit-equal to the polyphase of ops/pfb.py.
No JAX: the stage's values are held against the JAX kernels in
test_torch_channelizer.py and test_torch_pfb_variants.py."""

import numpy as np
import pytest
import torch

from radioframe_torch.kernels import fft_plan, pfb_plan
from radioframe_torch.ops.pfb import polyphase_frames

torch.set_num_threads(2)


# --- the plans -------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1 << n for n in range(4, 14)])
def test_plan_shapes(M):
    """K3 at every M the card takes: C = 8 CTAs of max(32, M/16) threads,
    each thread 2 columns and 8 frames a step, the step C G frames = 8 lanes'
    worth, within a block's shared memory; the run a whole number of steps."""
    p = pfb_plan.plan(M, 8, 2048, 16)
    T = fft_plan.threads(M)
    assert p.cluster == pfb_plan.CLUSTER == 8
    assert p.threads == max(32, T) and p.groups == p.threads // T
    assert p.step == p.cluster * p.groups == pfb_plan.FRAMES * p.lanes
    assert (M // p.cluster // pfb_plan.POINTS) * p.lanes == p.threads
    assert p.smem == pfb_plan.smem_bytes(M) <= pfb_plan.SMEM_LIMIT
    assert p.run_length % p.step == 0
    assert (p.runs - 1) * p.run_length < p.F <= p.runs * p.run_length
    assert p.grid == p.runs * 8


def test_plan_at_the_main_shapes():
    """K3 at config 5 (M = 4096, K = 8, F = 2048) on 30 resident clusters
    (two CTAs an SM, the H100's count): 29 runs of 72 frames, one frame a
    CTA a step; its shared memory is the FFT's twiddles, one exchange buffer
    and 7 history frames of 512 columns, two CTAs' worth within an SM. The
    sharded path's F_local = 512: 22 runs of 24. Frame -1 (F = 1): one run
    of one step."""
    k3 = pfb_plan.plan(4096, 8, 2048, 30)
    assert (k3.runs, k3.run_length, k3.step, k3.threads, k3.lanes) == (29, 72, 8, 256, 1)
    assert k3.smem == 8 * (1088 + 4352 + 7 * 512) == 72192
    assert 2 * k3.smem <= pfb_plan.SMEM_LIMIT
    loc = pfb_plan.plan(4096, 8, 512, 30)
    assert (loc.runs, loc.run_length) == (22, 24)
    one = pfb_plan.plan(4096, 8, 1, 30)
    assert (one.runs, one.run_length) == (1, 8)


@pytest.mark.parametrize("F,clusters,runs,L", [
    (2048, 1, 1, 2048), (2048, 3, 3, 688), (100, 16, 13, 8), (9, 16, 2, 8), (16, 16, 2, 8),
    (130, 7, 6, 24)])
def test_runs_cover_every_frame_once(F, clusters, runs, L):
    """At most the resident clusters, each run whole steps, the last run
    ragged where F is not a multiple; frames sum to F."""
    p = pfb_plan.plan(4096, 8, F, clusters)
    assert (p.runs, p.run_length) == (runs, L)
    assert (p.runs - 1) * p.run_length < F <= p.runs * p.run_length


def test_small_m_lanes():
    """Below M = 512 a CTA holds several FFT frames and its columns are few:
    the step is C G frames walked by J lanes of 8 (each reloading its
    history)."""
    p = pfb_plan.plan(64, 8, 128, 16)
    assert (p.threads, p.groups, p.step, p.lanes) == (32, 8, 64, 8)
    p = pfb_plan.plan(16, 8, 256, 16)
    assert (p.threads, p.groups, p.step, p.lanes) == (32, 32, 256, 32)


@pytest.mark.parametrize("args,match", [
    ((8, 8, 64, 16), "power-of-two M"), ((16384, 8, 64, 16), "power-of-two M"),
    ((96, 8, 64, 16), "power-of-two M"), ((4096, 0, 64, 16), "taps"),
    ((4096, 17, 64, 16), "taps"), ((4096, 8, 0, 16), "F >= 1"),
    ((4096, 8, 64, 0), "resident")])
def test_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        pfb_plan.plan(*args)


def test_plan_refuses_shared_memory_beyond_a_block(monkeypatch):
    """K3 at M = 8192 takes 144,448 B with 8 taps and 209,984 B with 16 (a
    ring of 15 history frames of 1024 columns), both within 227 KB; a
    smaller limit refuses the second and keeps the first."""
    assert pfb_plan.smem_bytes(8192) == 8 * (2184 + 8704 + 7 * 1024) == 144448
    assert pfb_plan.smem_bytes(8192, 16) == 8 * (2184 + 8704 + 15 * 1024) == 209984
    monkeypatch.setattr(pfb_plan, "SMEM_LIMIT", 150 * 1024)
    with pytest.raises(ValueError, match="shared memory"):
        pfb_plan.plan(8192, 16, 64, 16)
    assert pfb_plan.plan(8192, 8, 64, 16).smem == 144448


def test_taps_width():
    assert [pfb_plan.taps_width(k) for k in (1, 8, 9, 16)] == [8, 8, 16, 16]


def test_columns_plan():
    """pfb_only: 256-thread blocks of 512 columns, two blocks
    an SM over 132 SMs at config 5: 8 column blocks, 32 runs of 64 frames;
    at M = 64 one block of 32 threads a row."""
    p = pfb_plan.columns_plan(4096, 8, 2048, 132)
    assert (p.threads, p.cluster, p.step) == (256, 1, 8)
    assert (p.runs, p.run_length, p.grid) == (32, 64, 256)
    q = pfb_plan.columns_plan(64, 8, 64, 132)
    assert (q.threads, q.grid // q.runs) == (32, 1) and q.run_length % 8 == 0


def test_check_occupancy():
    p = pfb_plan.plan(4096, 8, 2048, 30)
    occ = dict(zip(pfb_plan.OCCUPANCY, (128, 2, 30, 8, 256, p.smem, 384, 132)))
    pfb_plan.check_occupancy(p, occ)
    with pytest.raises(RuntimeError, match="plan"):
        pfb_plan.check_occupancy(p, dict(occ, smem=p.smem - 8))
    c = pfb_plan.columns_plan(4096, 8, 2048, 132)
    pfb_plan.check_occupancy(c, dict(occ, cluster=0, smem=0))


def test_bytes_read_once_a_run():
    """The input K3's stage loads: every frame once, plus K - 1 frames
    before each run (10% at config 5's 29 runs of 72)."""
    p = pfb_plan.plan(4096, 8, 2048, 30)
    assert pfb_plan.bytes_read(p) == 8 * 4096 * (2048 + 29 * 7)


# --- the schedules, executed --------------------------------------------------------------


def _inputs(M, F, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, F * M)).astype(np.float32)
    t = rng.standard_normal((2, (K - 1) * M)).astype(np.float32)
    h = torch.from_numpy(rng.standard_normal((K, M)).astype(np.float32))
    return h, torch.complex(*torch.from_numpy(t))[None], *torch.from_numpy(x)


def _plain(h, tail, xr, xi):
    K, M = h.shape
    fr = torch.cat([tail[0].real, xr]).reshape(-1, M)
    fi = torch.cat([tail[0].imag, xi]).reshape(-1, M)
    return polyphase_frames(h, fr, fi)


@pytest.mark.parametrize("M,K,F,clusters", [
    (16, 8, 520, 2), (64, 8, 130, 1), (64, 4, 200, 3), (256, 8, 40, 16), (256, 12, 70, 2),
    (512, 8, 30, 3), (512, 16, 8, 1), (4096, 8, 17, 2)])
def test_cluster_schedule_is_the_polyphase(M, K, F, clusters):
    """K3's schedule (runs, steps, CTAs' column slices, lanes, the history
    carried in the ring or reloaded, each frame delivered to its CTA and
    group) computes every frame once, bit-equal to ops.pfb.polyphase_frames:
    one run and several, ragged last runs and steps, J = 1 and J > 1 (M <
    512), K below, at and above 8 (KW = 16)."""
    h, tail, xr, xi = _inputs(M, F, K, M + F)
    p = pfb_plan.plan(M, K, F, clusters)
    got = pfb_plan.execute(p, h, tail, xr, xi)
    for a, b in zip(got, _plain(h, tail, xr, xi)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,F,sms", [(64, 70, 4), (1024, 33, 1), (4096, 9, 132)])
def test_column_schedule_is_the_polyphase(M, F, sms):
    """pfb_only's schedule: every column down its run, the history shifted
    from step to step, bit-equal to polyphase_frames."""
    h, tail, xr, xi = _inputs(M, F, 8, M)
    p = pfb_plan.columns_plan(M, 8, F, sms)
    got = pfb_plan.execute(p, h, tail, xr, xi)
    for a, b in zip(got, _plain(h, tail, xr, xi)):
        assert torch.equal(a, b)


def test_execute_refuses_another_shape():
    h, tail, xr, xi = _inputs(64, 8, 8, 0)
    with pytest.raises(ValueError, match="plan"):
        pfb_plan.execute(pfb_plan.plan(64, 8, 16, 1), h, tail, xr, xi)
