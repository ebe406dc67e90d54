"""The station cell ``flagship_rx_x8.multi_stream``: a small run on the
CPU prints the contract's last line and is correct, a receiver fed another
receiver's block is not, the check's reference lead holds for an AM channel
in quadrature, and the cell's two readers give the planted numbers on a
made-up trace. On the card (``-m card``): eight flagship
Radios on eight threads give what they give one after another, each on a
stream of its own, and a lone Radio gives what it gave on the caller's
stream."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from rfbench import harness
from rfbench.metrics import kernel_overlap_pct, receiver_spread_ms
from rfbench.trace import DeviceTrace, Event

CELL = "flagship_rx_x8.multi_stream"
M = harness.load_json(harness.ROOT / "BENCHMARK.json")
DEVICE_ONLY = {"step_device_ms", "k1_roofline", "device_idle_pct", "kernel_overlap_pct"}
SPANS = {"pin_copy_gbps", "pinned_allocs", "inputs_in_place", "receiver_spread_ms"}


def _tiny(receivers=4):
    cell = harness.load_cell(CELL)
    sizes = harness.load_sizes(cell["config"])
    sizes.update(channels=4, receivers=receivers)
    cell.update(block=16384, warm_blocks=2, trace_blocks=4)
    return cell, sizes


def _run(trace=False, seconds=0.3):
    cell, sizes = _tiny()
    return harness.run_cell(CELL, 2 ** 31 + 99, seconds, trace, device="cpu", cell=cell,
                            sizes=sizes)


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_station_prints_the_contracts_line_and_is_correct(trace):
    r = _run(trace)
    back = json.loads(json.dumps(harness._plain(r), allow_nan=False))
    assert list(back)[-1] == "checks" and back["correct"] and back["failed"] == 0
    assert back["attempted"] > 0
    assert all(c["value"] <= c["limit"] / 10 for c in back["checks"].values()), back["checks"]
    want = {m["name"] for m in harness.cell_metrics(M, CELL, trace)}
    # the CPU run has no device trace, and so no program spans inside one
    assert set(back["metrics"]) == {n for n in want
                                    if n.split(".")[0] not in DEVICE_ONLY | SPANS}


def test_a_receiver_fed_anothers_block_is_not_correct(monkeypatch):
    cfg = harness.module("configs", "flagship_rx_x8")
    rows = cfg.receiver_block
    monkeypatch.setattr(cfg, "receiver_block",
                        lambda blk, sizes, r: rows(blk, sizes, 2 if r == 3 else r))
    r = _run()
    assert not r["correct"] and r["failed"] >= 1


def test_station_sizes():
    cfg = harness.module("configs", "flagship_rx_x8")
    sizes = harness.load_sizes("flagship_rx_x8")
    cell = harness.load_cell(CELL)
    assert cfg.receivers(sizes) == 8 and cfg.channels(sizes) == 1024
    assert cfg.samples_per_block(sizes, cell) == 1024 * 131072
    f = cfg.freqs_hz(sizes)
    assert f[0] == -500e3 and f[-1] == 500e3 and len(set(f[cfg.rows(sizes, 3)])) == 128
    assert cfg.rows(sizes, 7) == slice(896, 1024)


def test_the_lead_covers_an_am_channel_in_quadrature():
    """The check's premise for an AM channel whose sidebands lie in
    quadrature (its audio a sixteenth of its carrier): the reference started
    afresh the station's lead before a block gives that block as a start
    from block 0 does; the flagship's shorter lead does not (a short
    release keeps the CPU run small)."""
    import torch

    from rfbench.compare import audio_err
    from rfbench.configs import flagship_rx
    from rfbench.reference.plain import F64
    from rfbench.reference.rx import RxReference

    cfg = harness.module("configs", "flagship_rx_x8")
    cell, sizes = harness.load_cell(CELL), harness.load_sizes("flagship_rx_x8")
    sizes["agc"] = dict(sizes["agc"], release_s=0.05)
    cell.update(block=16384)
    T, fs = cell["block"], sizes["fs_in"]
    lead = cfg.reference_lead_blocks(sizes, cell)
    short = flagship_rx.reference_lead_blocks(sizes, cell)
    assert (lead, short) == (19, 10)
    k = lead + 2
    t = np.arange((k + 1) * T) / fs
    x = 0.3 * (1 + 0.5j * np.sin(2 * np.pi * 1000.0 * t)) * np.exp(2j * np.pi * 1e5 * t)
    ref = RxReference(sizes, [1e5], [2], "cpu")

    def block_k(start):
        st = ref.init_state(start, T, F64)
        with torch.no_grad():
            for j in range(start, k + 1):
                st, out = ref.step(st, torch.from_numpy(x[None, j * T:(j + 1) * T]), F64)
        return out["audio"]

    whole = block_k(0)
    assert audio_err(block_k(k - lead), whole, np.array([2]), 1.0) < 1e-9
    assert audio_err(block_k(k - short), whole, np.array([2]), 1.0) > 1e-3


# -- the readers on a made-up trace -------------------------------------------------

US = 1_000  # ns
T0 = 1_700_000_000_000_000_000


def _trace(events, blocks=2):
    tr = DeviceTrace(10.0, blocks)
    tr.first_kept_ns, tr.end_ns, tr.block_count = T0, T0 + 1_000 * US, blocks
    tr.events = [Event(n, T0 + a * US, T0 + b * US, True) for n, a, b in events]
    return tr


def test_kernel_overlap_reads_two_or_more_kernels_at_once():
    tr = _trace([("k1", 100, 300),          # alone 100-200, with k2 200-300
                 ("k2", 200, 400),          # alone 300-400
                 ("k3", 400, 500),          # back to back with k2: no overlap
                 ("Memcpy HtoD (Pinned -> Device)", 450, 900),  # copies are not kernels
                 ("k4", 950, 1_100)])       # clipped to 950-1000
    got = kernel_overlap_pct.read(harness.Run(trace=tr))
    assert got == pytest.approx(100.0 * 100 / (400 + 50))


def test_kernel_overlap_on_one_stream_is_zero_and_nothing_without_kernels():
    one = _trace([("k1", 100, 200), ("k2", 200, 300), ("k1", 300, 450)])
    assert kernel_overlap_pct.read(harness.Run(trace=one)) == 0.0
    copies = _trace([("Memcpy DtoH (Device -> Pinned)", 100, 200), ("Memset (Device)", 0, 50)])
    assert kernel_overlap_pct.read(harness.Run(trace=copies)) is None
    assert kernel_overlap_pct.read(harness.Run()) is None


def _span(a_us, b_us, stream):
    return SimpleNamespace(name="api.process", start_ns=T0 + a_us * US, end_ns=T0 + b_us * US,
                           nbytes=0, count=None, stream=stream)


def test_receiver_spread_reads_each_rounds_slowest_less_fastest(monkeypatch):
    from radioframe_torch.diag import timing

    planted = [_span(0, 100, 1), _span(10, 60, 2), _span(20, 90, 3),       # round 0: 100 - 50
               _span(500, 530, 2), _span(500, 700, 1), _span(510, 600, 3),  # round 1: 200 - 30
               _span(1_100, 1_200, 1)]                                       # outside
    monkeypatch.setattr(timing, "recorded", lambda: planted)
    run = harness.Run(trace=_trace([("k", 0, 10)]))
    assert receiver_spread_ms.read(run) == pytest.approx((0.050 + 0.170) / 2)


def test_receiver_spread_needs_streams(monkeypatch):
    from radioframe_torch.diag import timing

    run = harness.Run(trace=_trace([("k", 0, 10)]))
    one = [_span(0, 100, 1), _span(200, 260, 1)]
    monkeypatch.setattr(timing, "recorded", lambda: one)
    assert receiver_spread_ms.read(run) is None  # one stream: nothing to spread
    unmarked = [_span(0, 100, None), _span(10, 60, None)]
    monkeypatch.setattr(timing, "recorded", lambda: unmarked)
    assert receiver_spread_ms.read(run) is None  # a program whose spans carry no stream
    assert receiver_spread_ms.read(harness.Run()) is None


# -- on the card ------------------------------------------------------------------


def _station_on(card, receivers=8):
    import torch

    cfg = harness.module("configs", "flagship_rx_x8")
    cell, sizes = harness.load_cell(CELL), harness.load_sizes("flagship_rx_x8")
    sizes.update(receivers=receivers)
    cell.update(pool=3)
    from rfbench import signals

    pool = signals.make_pool(cfg.layout(sizes, cell), cell["signal"], 4242, card).cpu().numpy()
    torch.cuda.synchronize()
    return cfg, sizes, cell, pool


def _blocks(cfg, sizes, pool, r, n=3):
    return [cfg.receiver_block(cfg.block(pool, k), sizes, r) for k in range(n)]


@pytest.mark.card
def test_eight_radios_on_eight_threads_match_one_after_another(card):
    import threading

    import torch

    from radioframe_torch.diag import timing

    cfg, sizes, cell, pool = _station_on(card)
    n = cfg.receivers(sizes)
    seq_objs, par_objs = cfg.build_api(sizes, cell, card), cfg.build_api(sizes, cell, card)
    seq = [[np.array(o.process(b)) for b in _blocks(cfg, sizes, pool, r)]
           for r, o in enumerate(seq_objs)]
    par = [None] * n
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        def serve(r):
            par[r] = [np.array(par_objs[r].process(b)) for b in _blocks(cfg, sizes, pool, r)]
        threads = [threading.Thread(target=serve, args=(r,)) for r in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        spans = [s for s in timing.recorded() if s.name in ("api.process", "compiled.replay")]
    assert not any(t.is_alive() for t in threads)
    for r in range(n):
        for a, b in zip(par[r], seq[r], strict=True):
            np.testing.assert_array_equal(a, b)
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s.thread, set()).add(s.stream)
    assert len(by_thread) == n and all(len(v) == 1 for v in by_thread.values())
    assert len(set.union(*by_thread.values())) == n
    assert {o._stager.stream.cuda_stream for o in par_objs} == set.union(*by_thread.values())
    assert [o._compiled.replays for o in par_objs] == [o._compiled.replays for o in seq_objs]


@pytest.mark.card
def test_a_lone_radio_gives_what_it_gave_on_the_callers_stream(card):
    cfg, sizes, cell, pool = _station_on(card, receivers=1)
    own, caller = cfg.build_api(sizes, cell, card), cfg.build_api(sizes, cell, card)
    caller[0]._stager.stream = None  # the path before each object had a stream of its own
    for b in _blocks(cfg, sizes, pool, 0):
        np.testing.assert_array_equal(own[0].process(b), caller[0].process(b))
        np.testing.assert_array_equal(own[0].last_aux["power_in"].cpu().numpy(),
                                      caller[0].last_aux["power_in"].cpu().numpy())
