"""The compiled block step: the counterpart of the reference's
``jax.jit(step)`` at its API sites and of ``jax.jit(step,
donate_argnums=0)`` in its ``BlockStream``.

``CompiledStep(step, state, device=...)`` wraps a block step
``step(state, *inputs) -> (state, *outputs)`` and owns its state: static
tensors into which the step's new state is copied at the end of every block,
so the buffers the step reads its state from are the ones it leaves the
next state in, as XLA's donation makes them. A call's signature is the tree
structure, shapes and dtypes of its tensor inputs and the values of the
others (an int16 block, or a block of another length, is a signature of its
own).

A tensor input that already lies on the step's device is read where it
lies, as the reference's donated buffer is: the call is bound to that
buffer (its address, shape, strides and dtype). Up to ``BIND_CAP`` bindings
a signature; a call beyond them, an input from another device (the host's
memory on a card), and a device input whose memory is the step's own (its
state, or an output of the signature: a previous output fed back in) are
copied into static input buffers kept for the signature instead. The
caller must not overwrite a bound input before the stream reaches the step,
as it must not overwrite one that the copy reads. Reading in place pays
where the inputs' addresses repeat (a ring; a block the caching allocator
hands out again; an API object's controls, one tensor each, rewritten in
place: ``api/_block.py``): a fresh buffer every block costs a capture a
buffer up to the cap, then the copy.

On a CUDA device the first call of a signature runs the step once on a copy
of the state (the warm-up: it builds the kernels, plans cuFFT and fills the
launch caches; its results are discarded and it counts as real launches),
then captures the step and the state's copy-back as one CUDA graph; each
new binding (and the copying path) is captured once more, without a
warm-up, in the memory pool of the signature's first graph. That call and
every later one with the same binding is one ``replay()`` on the current
stream. A step that cannot be captured raises, naming the first line that
refused; nothing runs eagerly in its place. A replay runs no Python, so the
kernel wrappers' ``launches`` counters are advanced by what the capture
recorded (``_build.recording``: the launches of the capturing thread only,
so steps captured and replayed on several threads at once count exactly).
On the CPU the same bookkeeping runs and the step is called directly, on
the caller's tensors where a call is bound.

Host values the step reads by value are fixed at capture: the kernel
wrappers' plan knobs, the AGC's static scan forms and the TX chain's float
constants. A change to the last two calls ``invalidate()``, which makes
every ``CompiledStep`` set its signatures up again at its next call.

The outputs of a call are the graph's own tensors, overwritten by the next
call of the signature (the graphs of one signature share their memory): a
caller that keeps them clones them (``clone_tree``).

Spans (``diag.timing.span``, while a profiler runs): ``compiled.call``
around a call; inside it ``compiled.bind`` around the choice of binding
(``nbytes``: the bytes of the inputs read in place; ``count``: the bindings
the signature has), ``compiled.inputs`` around the copies into the static
inputs (``nbytes`` copied; ``count``: the inputs that came from another kind
of device, the host's memory on a card), ``compiled.capture`` on a new
binding (``count``: the signatures set up so far), and ``compiled.replay``
(CUDA; ``stream``: the stream it replayed on) or ``compiled.run`` (CPU).
The capture and replay spans carry as ``attrs`` what the step ``note``d
while it was captured (``RxChain``: ``back_path``, the back end it runs).
"""

from __future__ import annotations

import traceback
from pathlib import Path

import torch

from radioframe_torch.device import resolve
from radioframe_torch.diag.timing import noting, span, stream_id
from radioframe_torch.kernels import _build

_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_generation = 0  # bumped by invalidate()

# The bindings (device input buffers read in place) a signature keeps: a NIC
# ring of up to 8 slots. ``Stager``'s staged block takes one: the caching
# allocator hands the freed block out again. A call beyond them is copied.
BIND_CAP = 8


def invalidate() -> None:
    """A host value that captured steps read by value has changed: every
    ``CompiledStep`` sets its signatures up (captures) again at its next
    call."""
    global _generation
    _generation += 1


# -- trees: dicts, tuples and lists of leaves ------------------------------------


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _pairs(ref, new, path: str = "state"):
    """(path, ref leaf, new leaf) along ``ref``'s structure, which ``new``
    must share (dict keys in any order)."""
    if isinstance(ref, dict):
        if not isinstance(new, dict) or set(ref) != set(new):
            got = sorted(new) if isinstance(new, dict) else type(new).__name__
            raise ValueError(f"{path}: the step returned {got}, the state has {sorted(ref)}")
        for k in ref:
            yield from _pairs(ref[k], new[k], f"{path}[{k!r}]")
    elif isinstance(ref, (tuple, list)):
        if not isinstance(new, (tuple, list)) or len(ref) != len(new):
            raise ValueError(f"{path}: the step changed the state's structure")
        for i, (a, b) in enumerate(zip(ref, new)):
            yield from _pairs(a, b, f"{path}[{i}]")
    else:
        yield path, ref, new


def _spec(tree):
    """The hashable signature of a tree of inputs."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _spec(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_spec(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype)
    hash(tree)  # a non-tensor input is part of the signature by value
    return ("value", type(tree).__name__, tree)


def clone_tree(tree):
    """``tree`` with every tensor leaf cloned (outputs a caller keeps)."""
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _fits(a, b) -> bool:
    """May ``b`` be written into the static leaf ``a``?"""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype)
    return True


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (_storage(a) == _storage(b) and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and a.stride() == b.stride() and a.dtype == b.dtype)


def _refusal(exc: BaseException) -> str:
    """The line of the step where the first error of a failed capture rose
    (the innermost frame outside torch), with that error."""
    seen = []
    e = exc
    while e is not None and e not in seen:
        seen.append(e)
        e = e.__cause__ or e.__context__
    root = seen[-1]
    frames = [f for f in traceback.extract_tb(root.__traceback__)
              if not str(Path(f.filename).resolve()).startswith(_TORCH_DIR)]
    where = (f"{frames[-1].filename}:{frames[-1].lineno} in {frames[-1].name}: "
             f"{frames[-1].line}" if frames else "an unknown line")
    return f"{where} ({type(root).__name__}: {root})"


class _Run:
    """One way of running a signature (a binding, or the copying path): on
    CUDA its graph and outputs; the storages of its (last) outputs."""

    def __init__(self):
        self.graph = None         # torch.cuda.CUDAGraph on CUDA
        self.outputs = None       # the graph's output tree
        self.launches = []        # [(wrapper, launches, {variant: n})] a replay adds
        self.notes = {}           # what the step noted while captured (diag.timing.note)
        self.stores = set()       # storages of its outputs (the last call's on the CPU)


class _Signature:
    """One signature: its static inputs (made where a call first copies a
    leaf), its runs by binding and, on CUDA, the memory pool they share."""

    def __init__(self, n: int, state_stores: set):
        self.static = [None] * n  # the static buffer of each tensor leaf
        self.runs: dict = {}      # binding -> _Run
        self.pool = None          # the first graph's memory pool
        self._base = state_stores
        self.taken = set(state_stores)  # storages a bound input may not lie in

    @property
    def bound(self) -> int:
        """Runs that read an input in place (all but the copying path)."""
        return len(self.runs) - ((None,) * len(self.static) in self.runs)

    def retake(self) -> None:
        """Storages of the state, the static inputs and every run's
        outputs: memory the step writes, which a bound input may not share."""
        self.taken = self._base.union({_storage(t) for t in self.static if t is not None},
                                      *(r.stores for r in self.runs.values()))

    def produced(self, run: _Run, outs) -> None:
        """``run`` gave ``outs``: ``taken`` again where their storages are
        new (on CUDA once, at capture; on the CPU where the allocator moved
        them)."""
        stores = {_storage(t) for t in leaves(outs) if isinstance(t, torch.Tensor)}
        if stores != run.stores:
            run.stores = stores
            self.retake()


class CompiledStep:
    """``step(state, *inputs) -> (state, *outputs)`` as CUDA graphs on
    ``device``, one a signature and binding (on the CPU: the same
    bookkeeping, the step called directly). A tensor input on ``device`` is
    read where it lies, up to ``BIND_CAP`` buffers a signature; others are
    copied into static inputs. ``donate=True`` takes the caller's state
    tensors as the static buffers (they are consumed: they hold the latest
    state from then on); ``donate=False`` copies them, and reading ``state``
    returns a copy. Assigning ``state`` copies the tree into the static
    buffers (a tree of another layout replaces them and sets every
    signature up again). The outputs are the graph's own tensors,
    overwritten by the next call of the signature.

    >>> cs = CompiledStep(chain.step, chain.init_state(), device="cuda")
    >>> audio, aux = cs(iq, words, modes)      # the graph's tensors
    """

    def __init__(self, step, state, *, device, donate: bool = True, name: str | None = None):
        self.step = step
        self.name = name or getattr(step, "__qualname__", None) or repr(step)
        self.device = resolve(device)
        # where a bound input lies: "cuda" names the current card (cuda:0 != cuda)
        self._home = (torch.device("cuda", torch.cuda.current_device())
                      if self.device.type == "cuda" and self.device.index is None
                      else self.device)
        self.donate = bool(donate)
        self._side = None  # the stream of warm-ups and captures (CUDA)
        self._sigs: dict = {}
        self._generation = _generation
        self.signatures = 0  # signatures set up (again after invalidate or a new layout)
        self.binds = 0       # bindings set up (device inputs read in place)
        self.captures = 0    # CUDA graphs captured
        self.replays = 0     # CUDA graph replays
        self.copies = 0      # tensor inputs copied into static inputs
        self.blocks = 0      # calls
        self._state = self._adopt(state, self.donate)

    # -- the state ---------------------------------------------------------------

    def _adopt(self, tree, donate: bool):
        """Static buffers for ``tree``: its own tensors where donated and
        fit (on the device, non-overlapping), else copies."""
        seen = set()

        def one(t):
            if not isinstance(t, torch.Tensor):
                if self.device.type == "cuda" and t is not None:
                    raise TypeError(f"{self.name}: a state leaf of type {type(t).__name__} "
                                    "cannot live in a CUDA graph; make it a tensor")
                return t
            own = (donate and t.device == self.device and t.is_contiguous()
                   and _storage(t) not in seen)
            t = t if own else t.to(self.device, copy=True).contiguous()
            seen.add(_storage(t))
            return t

        with torch.no_grad():
            return tree_map(one, tree)

    @property
    def state(self):
        """The state after the last block (the live buffers when donated,
        else a copy)."""
        if self.donate:
            return self._state
        with torch.no_grad():
            return clone_tree(self._state)

    @state.setter
    def state(self, tree):
        try:
            fits = all(_fits(a, b) for _, a, b in _pairs(self._state, tree))
        except ValueError:
            fits = False
        if not fits:  # another layout: new buffers, every signature set up again
            self._state = self._adopt(tree, donate=False)
            self._sigs.clear()
            return
        with torch.no_grad():
            self._write_back(tree)

    # -- the block -------------------------------------------------------------------

    def _write_back(self, new_state) -> None:
        """Copy ``new_state`` into the static buffers (a new leaf that shares
        memory with a static one, but is not it, is cloned first); a
        non-tensor leaf (on the CPU) takes the new value."""
        pairs = list(_pairs(self._state, new_state))
        stores = {_storage(d) for _, d, _ in pairs if isinstance(d, torch.Tensor)}
        todo, values = [], []
        for path, dst, src in pairs:
            if not _fits(dst, src):
                def what(t):
                    return (f"{tuple(t.shape)} {t.dtype}" if isinstance(t, torch.Tensor)
                            else type(t).__name__)
                raise ValueError(f"{self.name}: {path} is {what(dst)} in the state, "
                                 f"{what(src)} from the step")
            if not isinstance(dst, torch.Tensor):
                if self.device.type == "cuda" and src is not dst:
                    raise ValueError(f"{self.name}: {path} is a value, not a tensor; a CUDA "
                                     "graph cannot carry it to the next block")
                values.append(src)
                continue
            values.append(dst)
            if not _same_view(src, dst):
                todo.append((dst, src.clone() if _storage(src) in stores else src))
        for dst, src in todo:
            dst.copy_(src)
        it = iter(values)
        self._state = tree_map(lambda _: next(it), self._state)

    def _outputs(self, outs, args):
        """The step's outputs, a tensor that shares memory with the static
        state or the inputs it read cloned (the next block would overwrite
        it)."""
        stores = {_storage(t) for t in leaves(self._state) + leaves(args)
                  if isinstance(t, torch.Tensor)}
        return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        and _storage(t) in stores else t, outs)

    def _run(self, args):
        out = self.step(self._state, *args)
        if not isinstance(out, tuple) or len(out) < 1:
            raise TypeError(f"{self.name}: a step returns (state, *outputs)")
        new_state, outs = out[0], out[1:]
        outs = self._outputs(outs, args)
        self._write_back(new_state)
        return outs

    def _bind(self, sig: _Signature, flat: list):
        """(binding, run) of a call: for each leaf the view read in place
        ((address, shape, strides, dtype) of a tensor on the device whose
        memory is not the step's own), or None where the call copies it; the
        copying binding (all None) once the signature has ``BIND_CAP``."""
        bind = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                     if isinstance(t, torch.Tensor) and t.device == self._home
                     and _storage(t) not in sig.taken else None for t in flat)
        run = sig.runs.get(bind)
        if run is None and sig.bound >= BIND_CAP and any(b is not None for b in bind):
            bind = (None,) * len(flat)
            run = sig.runs.get(bind)
        return bind, run

    def _copy_inputs(self, sig: _Signature, flat: list, bind: tuple) -> None:
        """Copy each tensor leaf the binding does not read in place into its
        static input (made at its first copy)."""
        with span("compiled.inputs") as sp:
            pairs = []
            for i, (t, b) in enumerate(zip(flat, bind)):
                if b is None and isinstance(t, torch.Tensor):
                    if sig.static[i] is None:
                        sig.static[i] = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                        sig.retake()
                    pairs.append((sig.static[i], t))
            for dst, src in pairs:
                dst.copy_(src)
            self.copies += len(pairs)
            if sp:
                sp.nbytes = sum(s.nbytes for _, s in pairs)
                sp.count = sum(s.device.type != self.device.type for _, s in pairs)

    def _args(self, sig: _Signature, inputs, flat: list, bind: tuple):
        """The inputs the step reads: the caller's where bound, else the
        static buffers."""
        it = iter(sig.static[i] if b is None and isinstance(t, torch.Tensor) else t
                  for i, (t, b) in enumerate(zip(flat, bind)))
        return tree_map(lambda _: next(it), inputs)

    def _record(self, sig: _Signature, args):
        """Capture the step and the state's copy-back on the current stream
        in the signature's pool: (graph, outputs, the launches recorded,
        what the step noted), the launch counters left as they were."""
        graph = torch.cuda.CUDAGraph()
        with _build.recording() as launches, noting() as notes:
            graph.capture_begin(*(() if sig.pool is None else (sig.pool,)),
                                capture_error_mode="thread_local")
            try:
                outs = self._run(args)
            finally:
                graph.capture_end()
        return graph, outs, launches, notes

    def _capture(self, sig: _Signature, run: _Run, args) -> None:
        """Warm up on a copy of the state (a signature's first capture), then
        capture, both on the step's side stream. Not ``torch.cuda.graph``: it
        empties torch's caching allocators before every capture, which gives
        the next staged block a fresh address (a new binding: another
        capture) and frees the page-locked buffers. A capture takes new
        memory from ``cudaMalloc``, never the blocks the allocator keeps
        free for its other pools: short of it, those are freed and the
        capture made once more."""
        cur = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        side = self._side
        side.wait_stream(cur)
        try:
            with torch.cuda.stream(side):
                if sig.pool is None:
                    self.step(clone_tree(self._state), *args)
                try:
                    try:
                        graph, outs, run.launches, run.notes = self._record(sig, args)
                    except torch.OutOfMemoryError:
                        torch.cuda.empty_cache()
                        graph, outs, run.launches, run.notes = self._record(sig, args)
                except Exception as e:
                    raise RuntimeError(f"CompiledStep({self.name}): the step refused CUDA "
                                       f"graph capture at {_refusal(e)}") from e
        finally:
            cur.wait_stream(side)
        run.graph, run.outputs = graph, outs
        if sig.pool is None:
            sig.pool = graph.pool()
        self.captures += 1

    def _setup(self, sig: _Signature, bind: tuple, args) -> _Run:
        """A new binding of ``sig``: on CUDA its captured graph; kept once
        it is whole."""
        run = _Run()
        if self.device.type == "cuda":
            self._capture(sig, run, args)
        sig.runs[bind] = run
        if run.outputs is not None:
            sig.produced(run, run.outputs)
        if any(b is not None for b in bind):
            self.binds += 1
        return run

    def __call__(self, *inputs):
        """One block: returns the step's outputs after the state."""
        if self._generation != _generation:
            self._sigs.clear()
            self._generation = _generation
        with span("compiled.call"), torch.no_grad():
            key = _spec(inputs)
            sig = self._sigs.get(key)
            flat = leaves(inputs)
            if sig is None:
                sig = _Signature(len(flat), {_storage(t) for t in leaves(self._state)
                                             if isinstance(t, torch.Tensor)})
            with span("compiled.bind") as sp:
                bind, run = self._bind(sig, flat)
                if sp:
                    sp.nbytes = sum(t.nbytes for t, b in zip(flat, bind) if b is not None)
                    sp.count = sig.bound + (run is None and any(b is not None for b in bind))
            self._copy_inputs(sig, flat, bind)
            if run is None:
                with span("compiled.capture") as sp:
                    if key not in self._sigs:
                        self.signatures += 1
                    run = self._setup(sig, bind, self._args(sig, inputs, flat, bind))
                    self._sigs[key] = sig
                    if sp:
                        sp.count = self.signatures
                        sp.attrs = run.notes
            if self.device.type != "cuda":
                with span("compiled.run") as sp, noting() as run.notes:
                    outs = self._run(self._args(sig, inputs, flat, bind))
                if sp:
                    sp.attrs = run.notes
                sig.produced(run, outs)
            else:
                with span("compiled.replay") as sp:
                    run.graph.replay()
                    _build.advance(run.launches)
                if sp:  # read once the span is closed: 10-18 us under a profiler, not the replay's
                    sp.stream = stream_id(self.device)
                    sp.attrs = run.notes
                self.replays += 1
                outs = run.outputs
            self.blocks += 1
            return outs
