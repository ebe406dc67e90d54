"""Stage-pipelined RX executor (counterpart of ``radioframe/shard/pipeline.py``).

The receive chain's two halves are heterogeneous programs: the full-rate
front half (``RxChain.step_front``: the NCO mix and decimators, K1 or K2)
and the audio-rate back half (``step_back``: the mode bank, demod and AGC,
K6 or the dense ops). ``PipelinedRx`` runs them as two stages, a depth-2
pipeline with one block of latency: front(k + 1) is enqueued before back(k),
and only the decimated block ``(x, power_in)`` links them.

- On one card the stages run on two CUDA streams of it. An event recorded
  after front(k) orders back(k) behind it; the hand kernels launch on the
  current stream, so a ``torch.cuda.stream`` context places them.
- Across two cards ``(x, power_in)`` crosses with a non-blocking peer copy
  ordered between the front card's stream and the back card's stream.
- On the CPU the stages run in order: the same operations as
  ``RxChain.step``, so the result is bit-equal to it.

``x`` and ``power_in`` are allocated on the front stream and read on the
back stream. Each is recorded on the back stream, so that the caching
allocator does not hand their memory to front(k + 2) while back(k) still
reads it (the CUDA form of the fault the reference's executor notes: blocks
reused while a transfer still read them clobbered ~1% of samples).

The throughput gain is bounded by the slower stage; on one card both
stages share the device, so what overlaps is the host's launch work of one
stage with the device work of the other.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from radioframe_torch.device import resolve


def _card(dev: torch.device) -> torch.device:
    """``dev`` with its index: ``cuda`` is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class PipelinedRx:
    """Two-stage pipelined RX: ``step_front`` on ``device_front``,
    ``step_back`` on ``device_back`` (each the chain's device by default).

    ``run(fstate, bstate, blocks, words, mode)`` streams the blocks through
    the pipeline and returns the per-block audio and aux in order, equal to
    sequential ``RxChain.step``."""

    def __init__(self, chain, device_front=None, device_back=None):
        self.chain = chain
        home = _card(chain.device)
        self.dev_front = home if device_front is None else _card(resolve(device_front))
        self.dev_back = home if device_back is None else _card(resolve(device_back))
        if self.dev_front.type != self.dev_back.type:
            raise ValueError(f"stages on {self.dev_front} and {self.dev_back}: one device type")
        # each stage's copy of the chain's buffers (taps, tables) on its device
        self._front = chain if self.dev_front == home else copy.deepcopy(chain).to(self.dev_front)
        self._back = chain if self.dev_back == home else copy.deepcopy(chain).to(self.dev_back)
        cuda = self.dev_front.type == "cuda"
        self._sf = torch.cuda.Stream(self.dev_front) if cuda else None
        self._sb = torch.cuda.Stream(self.dev_back) if cuda else None

    def init_states(self, num_channels: int):
        """(front state on the front device, back state on the back device)."""
        return (self._front.split_state(self._front.init_state(num_channels))[0],
                self._back.split_state(self._back.init_state(num_channels))[1])

    def _ctx(self, stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def run(self, fstate, bstate, blocks, words, mode):
        """Stream ``blocks`` (each (C, T) or (1, T) complex64, numpy or
        torch) through the pipeline. Returns (fstate, bstate, audios, auxes).
        """
        sf, sb = self._sf, self._sb
        if sf is not None:  # the stages start after the caller's queued work
            sf.wait_stream(torch.cuda.current_stream(self.dev_front))
            sb.wait_stream(torch.cuda.current_stream(self.dev_back))
        with self._ctx(sf):
            words_f = torch.as_tensor(words).to(self.dev_front)
        with self._ctx(sb):
            mode_b = torch.as_tensor(mode).to(self.dev_back)
        audios, auxes = [], []
        pending = None
        for iq in blocks:
            iq = torch.as_tensor(iq)
            if sf is not None and iq.device == self.dev_front:
                # made on the caller's stream (a generator's block): read after it
                sf.wait_stream(torch.cuda.current_stream(self.dev_front))
                iq.record_stream(sf)
            with torch.no_grad(), self._ctx(sf):
                iq = iq.to(self.dev_front)
                fstate, x, pw = self._front.step_front(fstate, iq, words_f)
                nxt = self._hand_over(x, pw)
            if pending is not None:
                bstate = self._back_step(bstate, pending, mode_b, audios, auxes)
            pending = nxt
        if pending is not None:  # drain the pipeline
            bstate = self._back_step(bstate, pending, mode_b, audios, auxes)
        if sf is not None:  # the caller's stream reads the results after both stages
            for dev, s, tree in ((self.dev_front, sf, fstate),
                                 (self.dev_back, sb, (bstate, audios, auxes))):
                cur = torch.cuda.current_stream(dev)
                cur.wait_stream(s)
                for t in _leaves(tree):
                    t.record_stream(cur)
        return fstate, bstate, audios, auxes

    def _hand_over(self, x, pw):
        """(x, pw, event) for the back stage: on the CPU as they are; on one
        card behind an event on the front stream; across cards copied onto
        the back card (the copy runs on the front card's stream between a
        barrier each way with the back card's current stream)."""
        if self._sf is None:
            return x, pw, None
        if self.dev_back != self.dev_front:
            with torch.cuda.stream(self._sb):  # the back card's current stream
                x = x.to(self.dev_back, non_blocking=True)
                pw = pw.to(self.dev_back, non_blocking=True)
            return x, pw, None
        done = torch.cuda.Event()
        done.record(self._sf)
        return x, pw, done

    def _back_step(self, bstate, pending, mode_b, audios, auxes):
        x, pw, done = pending
        if done is not None:
            self._sb.wait_event(done)
            x.record_stream(self._sb)  # allocated on the front stream, read here
            pw.record_stream(self._sb)
        with torch.no_grad(), self._ctx(self._sb):
            bstate, audio, aux = self._back.step_back(bstate, x, mode_b, pw)
        audios.append(audio)
        auxes.append(aux)
        return bstate

