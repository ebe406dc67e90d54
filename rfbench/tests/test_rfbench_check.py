"""The check that decides ``correct``: a sound run passes; the control (the
reference in TF32) fails; a run with the timed path broken underneath
fails; and the reference's fresh start a lead before a checked block gives
that block as a start from block 0 does."""

import numpy as np
import pytest
import torch

from rfbench import control, harness
from rfbench.compare import compare
from rfbench.reference.plain import F64
from rfbench.tests.tiny import run_tiny, tiny

CELLS = ["flagship_rx.host", "channelizer_4096.device"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] / 10 for c in r["checks"].values()), r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    c, s = tiny(cell)
    got = control.control_readings(cell, 2024, 40, "cpu", c, s)
    limits = c["check"]["limits"]
    assert any(v > 3 * limits[n] for n, v in got.items()), got


def _patched(monkeypatch, config, broken):
    """Break the chain's step the configuration's entries drive."""
    if config == "flagship_rx":
        from radioframe_torch.pipelines.rx_chain import RxChain as Chain
    else:
        from radioframe_torch.pipelines.channelizer import ChannelizerChain as Chain
    orig = Chain.step

    def step(self, state, *args):
        new, audio, aux = orig(self, state, *args)
        return broken(state, new, audio, aux)
    monkeypatch.setattr(Chain, "step", step)


def _state_unchanged(state, new, audio, aux):
    return state, audio, aux


def _half_the_channels(state, new, audio, aux):
    audio = audio.clone()
    audio[audio.shape[0] // 2:] = 0.0
    return new, audio, aux


def _one_answer_altered(state, new, audio, aux):
    audio = audio.clone()
    audio[1, audio.shape[1] // 3] += 5e-2 * float(audio[1].abs().max())
    return new, audio, aux


@pytest.mark.parametrize("entry_cell", ["flagship_rx.host", "flagship_rx.device",
                                        "channelizer_4096.host", "channelizer_4096.device"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_channels, _one_answer_altered],
                         ids=["state_unchanged", "half_the_channels", "one_answer_altered"])
def test_broken_timed_path_is_not_correct(monkeypatch, entry_cell, fault):
    _patched(monkeypatch, harness.load_cell(entry_cell)["config"], fault)
    r = run_tiny(entry_cell, seconds=0.2)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("config, release_s", [("flagship_rx", 0.5), ("channelizer_4096", 0.05)])
def test_fresh_start_a_lead_before_matches_the_start(config, release_s):
    """The check's premise: from a fresh state, with the DDS and BFO
    accumulators worked out from the block count, ``reference_lead_blocks``
    blocks of the same stream bring every state to what it is after all the
    blocks from the first (the channelizer with a shorter release, so the
    lead holds a CPU test's block count)."""
    cell, sizes = tiny(f"{config}.device")
    sizes["agc"] = dict(sizes["agc"], release_s=release_s)
    cfg = harness.module("configs", config)
    ctx = harness.Context("x", cell, sizes, cfg, 77, 0.0, False, "cpu", 0.0)
    pool = harness.make_pool(ctx)
    lead = cfg.reference_lead_blocks(sizes, cell)
    k = lead + 3
    ref = cfg.reference(sizes, "cpu")
    outs = []
    for s in (0, k - lead):
        st = ref.init_state(s, cell["block"], F64)
        with torch.no_grad():
            for j in range(s, k + 1):
                st, out = ref.step(st, cfg.block(pool, j), F64)
        outs.append(out)
    nums = compare(outs[1], outs[0], cfg.CHECKS, cfg.modes(sizes), cfg.nfm_period(sizes))
    assert max(nums.values()) < 1e-9, nums


def test_keep_draws_from_the_seed():
    a, b = harness.Keep(3, 9), harness.Keep(3, 9)
    da = [a.wants() for _ in range(500)]
    assert da == [b.wants() for _ in range(500)]
    assert da[:3] == [0, 1, 2] and sum(x is not None for x in da[3:]) > 3
    assert not np.all([x is None for x in da[100:]])
