"""Several API objects on one device, one caller thread each, in lockstep
(the ``flagship_rx_x8`` station of ``rfbench/`` at a small size, on the
CPU): each block's outputs are bit-equal to the same objects run one after
another on one thread and agree with the plain reference within the
flagship's limits; each ``CompiledStep``'s bookkeeping and the kernel
wrappers' launch counters come out as in the sequential run. The launch
counters stay exact under threads that capture and replay at once (a
stress test of ``kernels/_build``), and a span's ``stream`` reaches the
trace's file. On a card the same station runs in ``rfbench/tests``
(``-m card``): eight Radios on eight threads, each on a stream of its own.
"""

import gzip
import json
import queue
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from radioframe_torch.core.stream import Stager
from radioframe_torch.diag import timing
from radioframe_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from rfbench import harness, signals  # noqa: E402
from rfbench.compare import compare  # noqa: E402
from rfbench.reference.plain import F64  # noqa: E402

torch.set_num_threads(2)

BLOCKS = 6
JOIN_S = 120.0


def _station(receivers=4, channels=4, T=16384):
    """(config module, sizes, cell, pool) of a small station: ``receivers``
    Radios of ``channels`` channels, each its own tunings and signals."""
    cell = harness.load_cell("flagship_rx_x8.multi_stream")
    sizes = harness.load_sizes("flagship_rx_x8")
    sizes.update(channels=channels, receivers=receivers)
    cell.update(block=T, pool=BLOCKS)
    cfg = harness.module("configs", "flagship_rx_x8")
    pool = signals.make_pool(cfg.layout(sizes, cell), cell["signal"], 20240611, "cpu").numpy()
    return cfg, sizes, cell, pool


def _monitor(M=64, T=4096):
    cell = harness.load_cell("channelizer_4096.host")
    sizes = harness.load_sizes("channelizer_4096")
    sizes.update(num_channels=M)
    cell.update(block=T, pool=BLOCKS)
    cfg = harness.module("configs", "channelizer_4096")
    pool = signals.make_pool(cfg.layout(sizes, cell), cell["signal"], 77, "cpu").numpy()
    return cfg.build_api(sizes, cell, "cpu"), [cfg.block(pool, k) for k in range(BLOCKS)]


def _outputs(obj, audio):
    return {"audio": np.array(audio), **{k: v.clone() for k, v in obj.last_aux.items()}}


def _sequential(objs, blocks):
    """outs[k][i]: object i's outputs of block k, run one after another."""
    return [[_outputs(o, o.process(b[k])) for o, b in zip(objs, blocks)]
            for k in range(BLOCKS)]


def _lockstep(objs, blocks):
    """The same, one caller thread an object: block k of every object is
    handed out at once, and the next only once all have returned."""
    inboxes = [queue.Queue() for _ in objs]
    outbox = queue.Queue()

    def serve(i):
        while (k := inboxes[i].get()) is not None:
            try:
                outbox.put((i, _outputs(objs[i], objs[i].process(blocks[i][k])), None))
            except Exception as e:  # raised again on the main thread
                outbox.put((i, None, e))

    threads = [threading.Thread(target=serve, args=(i,), daemon=True) for i in range(len(objs))]
    for t in threads:
        t.start()
    outs = []
    try:
        for k in range(BLOCKS):
            for q in inboxes:
                q.put(k)
            got = {}
            for _ in objs:
                i, out, err = outbox.get(timeout=JOIN_S)
                if err is not None:
                    raise err
                got[i] = out
            outs.append([got[i] for i in range(len(objs))])
    finally:
        for q in inboxes:
            q.put(None)
        for t in threads:
            t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads)
    return outs


def _books(obj):
    """The object's step bookkeeping and its kernel wrappers' counters."""
    c = obj._compiled
    launches = [(type(m).__name__, m.launches, dict(getattr(m, "variant_launches", {})))
                for m in obj.chain.modules() if hasattr(m, "launches")]
    return (c.signatures, c.binds, c.captures, c.replays, c.copies, c.blocks), launches


def _assert_equal(a, b):
    for row_a, row_b in zip(a, b, strict=True):
        for x, y in zip(row_a, row_b, strict=True):
            assert set(x) == set(y)
            for key in x:
                np.testing.assert_array_equal(np.asarray(x[key]), np.asarray(y[key]), key)


def test_four_radios_in_lockstep_match_the_sequential_run_and_the_reference():
    cfg, sizes, cell, pool = _station()
    blocks = [[cfg.receiver_block(cfg.block(pool, k), sizes, r) for k in range(BLOCKS)]
              for r in range(cfg.receivers(sizes))]
    alone, together = cfg.build_api(sizes, cell, "cpu"), cfg.build_api(sizes, cell, "cpu")
    seq = _sequential(alone, blocks)
    par = _lockstep(together, blocks)
    _assert_equal(par, seq)
    assert [_books(o) for o in together] == [_books(o) for o in alone]
    sigs, _, captures, replays, _, calls = _books(together[0])[0]
    assert (sigs, captures, replays, calls) == (1, 0, 0, BLOCKS)  # no graphs on the CPU
    # every receiver's channels against the plain reference in float64
    ref = cfg.reference(sizes, "cpu")
    limits = cell["check"]["limits"]
    st = ref.init_state(0, cell["block"], F64)
    for k in range(BLOCKS):
        with torch.no_grad():
            st, want = ref.step(st, torch.from_numpy(cfg.block(pool, k)), F64)
        got = cfg.station_outputs([{"audio": o["audio"], "power_in": o["power_in"]}
                                   for o in par[k]])
        nums = compare(got, want, cfg.CHECKS, cfg.modes(sizes), cfg.nfm_period(sizes))
        if k > 0:  # block 0 carries the cold-start AGC transient: the check never reads it
            assert all(v <= limits[n] / 10 for n, v in nums.items()), (k, nums)


def test_a_monitor_beside_two_radios_matches_the_sequential_run():
    cfg, sizes, cell, pool = _station(receivers=2)
    r_blocks = [[cfg.receiver_block(cfg.block(pool, k), sizes, r) for k in range(BLOCKS)]
                for r in range(2)]
    objs = []
    for _ in range(2):
        mon, m_blocks = _monitor()
        objs.append(cfg.build_api(sizes, cell, "cpu") + [mon])
    blocks = r_blocks + [m_blocks]
    seq = _sequential(objs[0], blocks)
    par = _lockstep(objs[1], blocks)
    _assert_equal(par, seq)
    assert [_books(o) for o in objs[1]] == [_books(o) for o in objs[0]]


def test_api_objects_on_the_cpu_have_no_stream_of_their_own():
    st = Stager("cpu", own_stream=True)
    assert st.stream is None
    with st.running():
        pass
    cfg, sizes, cell, _ = _station(receivers=1)
    assert cfg.build_api(sizes, cell, "cpu")[0]._stager.stream is None


class _Wrapper:
    def __init__(self):
        self.launches = 0
        self.variant_launches = {"a": 0, "b": 0}


def test_launch_counters_stay_exact_under_threads():
    """Threads that capture (record their own launches) and replay (advance
    by them) at once, and launch one shared wrapper directly: each capture
    holds its own thread's launches alone and no count is lost."""
    n_threads, rounds = 16, 200
    own = [_Wrapper() for _ in range(n_threads)]
    shared = _Wrapper()
    recorded = [None] * n_threads
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(timeout=JOIN_S)
        for _ in range(rounds):
            with _build.recording() as made:
                _build.launched(own[i], "a")
                _build.launched(own[i])
                _build.launched(shared, "b")
            recorded[i] = made
            _build.advance(made)
            _build.launched(shared)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for i, w in enumerate(own):
        assert sorted(recorded[i], key=lambda x: x[0] is shared) == [
            (w, 2, {"a": 1}), (shared, 1, {"b": 1})]
        assert (w.launches, w.variant_launches) == (2 * rounds, {"a": rounds, "b": 0})
    assert shared.launches == 2 * n_threads * rounds
    assert shared.variant_launches == {"a": 0, "b": n_threads * rounds}


def test_a_spans_stream_reaches_the_trace(tmp_path):
    with timing.trace(str(tmp_path), device="cpu"):
        with timing.span("api.process", root=True) as sp:
            sp.stream = 7
        with timing.span("stager.take"):
            pass
    assert timing.stream_id("cpu") is None
    (path,) = tmp_path.glob("plugins/profile/*/*.trace.json.gz")
    with gzip.open(path, "rt") as f:
        lane = {e["name"]: e for e in json.load(f)["traceEvents"]
                if e.get("pid") == "radioframe" and e.get("ph") == "X"}
    assert lane["api.process"]["args"]["stream"] == 7
    assert "stream" not in lane["stager.take"]["args"]
