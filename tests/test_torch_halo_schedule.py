"""K7's parity schedule (``radioframe_torch/kernels/halo_dma.py`` ``schedule``
and the buffer layout), driven as the card runs it: every rank's stream
executes put(1), recv(1), put(2), recv(2), ... in order, each op only once
its wait on a word of the rank's own buffer is satisfied (a stream wait,
GEQ), and ranks interleave at random. A put writes the right neighbour's
slot and flag; a recv reads its own slot and writes the left neighbour's
ack word. Words live at the byte offsets the wrapper passes to the kernels,
so two fields that overlapped would corrupt each other here too.

Held: a slot is never written before the previous call that used it was
received and acknowledged; every recv waits for, and finds, exactly its own
call number and its left neighbour's payload of that call; no interleaving
deadlocks; with two ranks on the time axis (a (2, 2) mesh), where the left
and the right neighbour are one buffer, flag and ack fields stay apart. A
schedule that waits for too old an ack is caught."""

import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from radioframe_torch.kernels import halo_dma as K7

CALLS = 100
SLOT_FLOATS = 64


class _Rank:
    def __init__(self):
        self.words = {}     # byte offset -> u64 value (flags and ack)
        self.payload = {}   # slot offset -> (sender, call)
        self.unread = set()  # slot offsets written and not yet received
        self.pc = 0         # next op: 2 (s - 1) is put(s), 2 (s - 1) + 1 is recv(s)


def _run(D: int, rng, schedule=K7.schedule, calls: int = CALLS) -> int:
    """One random interleaving of ``calls`` exchanges on a ring of D ranks;
    returns the number of ops run."""
    ranks = [_Rank() for _ in range(D)]
    ops = 0
    while any(r.pc < 2 * calls for r in ranks):
        ready = []
        for d, r in enumerate(ranks):
            if r.pc >= 2 * calls:
                continue
            c = schedule(r.pc // 2 + 1)
            if r.pc % 2 == 0:  # put: waits on its own ack word
                ok = r.words.get(K7.ack_offset(), 0) >= c.ack_wait
            else:              # recv: waits on its own flag
                ok = r.words.get(K7.flag_offset(c.slot), 0) >= c.flag
            if ok:
                ready.append(d)
        assert ready, f"deadlock: program counters {[r.pc for r in ranks]}"
        d = rng.choice(ready)
        r = ranks[d]
        s = r.pc // 2 + 1
        c = schedule(s)
        if r.pc % 2 == 0:
            dst = ranks[(d + 1) % D]
            slot = K7.slot_offset(c.slot, SLOT_FLOATS)
            assert slot not in dst.unread, f"rank {d} call {s}: slot overwritten before its ack"
            dst.payload[slot] = (d, s)
            dst.unread.add(slot)
            dst.words[K7.flag_offset(c.slot)] = c.flag
        else:
            assert c.flag == s, f"call {s} waits for {c.flag}"
            seen = r.words[K7.flag_offset(c.slot)]
            assert seen == s, f"rank {d} call {s}: the flag holds {seen}"
            slot = K7.slot_offset(c.slot, SLOT_FLOATS)
            assert r.payload[slot] == ((d - 1) % D, s), f"rank {d} call {s}: {r.payload[slot]}"
            r.unread.discard(slot)
            ranks[(d - 1) % D].words[K7.ack_offset()] = c.ack
        r.pc += 1
        ops += 1
    return ops


@pytest.mark.parametrize("D", [2, 3, 4])
@settings(max_examples=25, deadline=None, derandomize=True)
@given(rng=st.randoms(use_true_random=False))
def test_random_interleavings_keep_the_contract(D, rng):
    assert _run(D, rng) == 2 * CALLS * D


def test_schedule_values():
    """Slot and flag by parity; the put waits for the ack of the call before;
    the recv waits for and acknowledges its own number."""
    for s in range(1, 2 * CALLS):
        c = K7.schedule(s)
        assert (c.slot, c.flag, c.ack_wait, c.ack) == (s & 1, s, s - 1, s)
    with pytest.raises(ValueError):
        K7.schedule(0)


def test_layout_keeps_flags_ack_and_slots_apart():
    """Within one buffer (the only one when left and right are one rank):
    distinct header words, on separate 64-byte lines for flags and ack,
    8-byte aligned for the stream waits, and slots past the header."""
    flags = [K7.flag_offset(i) for i in (0, 1)]
    ack = K7.ack_offset()
    assert len({*flags, ack}) == 3
    assert all(o % 8 == 0 and o + 8 <= K7.HEADER_BYTES for o in (*flags, ack))
    assert {o // 64 for o in flags}.isdisjoint({ack // 64})
    assert K7.slot_offset(0, SLOT_FLOATS) >= K7.HEADER_BYTES
    assert K7.slot_offset(1, SLOT_FLOATS) == K7.slot_offset(0, SLOT_FLOATS) + 4 * SLOT_FLOATS
    assert K7.buffer_bytes(SLOT_FLOATS) == K7.slot_offset(1, SLOT_FLOATS) + 4 * SLOT_FLOATS


@pytest.mark.parametrize("D", [3, 4])
def test_a_schedule_that_waits_for_too_old_an_ack_is_caught(D):
    """Mutation check of the harness: with the put waiting for the ack of
    call s - 3, some interleaving overwrites a slot that was not received.
    (At D = 2 stream order alone protects the slot: the neighbour's put of
    call s - 1, which this rank's put of s follows, comes after that
    neighbour's recv of s - 2.)"""
    import random

    def loose(s):
        return dataclasses.replace(K7.schedule(s), ack_wait=max(0, s - 3))

    with pytest.raises(AssertionError, match="overwritten|holds|rank"):
        for seed in range(200):
            _run(D, random.Random(seed), schedule=loose)
