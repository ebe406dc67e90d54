"""The compiled block step: the counterpart of the reference's
``jax.jit(step)`` at its API sites and of ``jax.jit(step,
donate_argnums=0)`` in its ``BlockStream``.

``CompiledStep(step, state, device=...)`` wraps a block step
``step(state, *inputs) -> (state, *outputs)`` and owns its state: static
tensors into which the step's new state is copied at the end of every block,
so the buffers the step reads its state from are the ones it leaves the
next state in, as XLA's donation makes them. Each call copies the block's
inputs into static input buffers kept for the call's signature: the tree
structure, shapes and dtypes of the tensor inputs and the values of the
others (an int16 block, or a block of another length, is a signature of its
own).

On a CUDA device the first call of a signature runs the step once on a copy
of the state (the warm-up: it builds the kernels, plans cuFFT and fills the
launch caches; its results are discarded and it counts as real launches),
then captures the step and the state's copy-back as one CUDA graph; that
call and every later one of the signature is one ``replay()`` on the
current stream. A step that cannot be captured raises, naming the first
line that refused; nothing runs eagerly in its place. A replay runs no
Python, so the kernel wrappers' ``launches`` counters (``_build.COUNTED``)
are advanced by what the capture recorded. On the CPU the same bookkeeping
runs and the step is called directly.

Host values the step reads by value are fixed at capture: the kernel
wrappers' plan knobs, the AGC's static scan forms and the TX chain's float
constants. A change to the last two calls ``invalidate()``, which makes
every ``CompiledStep`` set its signatures up again at its next call.

The outputs of a call are the graph's own tensors, overwritten by the next
call of the signature: a caller that keeps them clones them
(``clone_tree``).

Spans (``diag.timing.span``, while a profiler runs): ``compiled.call``
around a call; inside it ``compiled.capture`` on a new signature (``count``:
the signatures set up so far), ``compiled.inputs`` around the copies into
the static inputs (``nbytes`` copied; ``count``: the inputs that came from
another kind of device, the host's memory on a card), and
``compiled.replay`` (CUDA) or ``compiled.run`` (CPU).
"""

from __future__ import annotations

import traceback
from pathlib import Path

import torch

from radioframe_torch.device import resolve
from radioframe_torch.diag.timing import span
from radioframe_torch.kernels import _build

_TORCH_DIR = str(Path(torch.__file__).resolve().parent)
_generation = 0  # bumped by invalidate()


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


# -- the launch counters -----------------------------------------------------------


def _counts() -> dict:
    return {w: (w.launches, dict(getattr(w, "variant_launches", {})))
            for w in list(_build.COUNTED)}


def _delta(before: dict, after: dict) -> list:
    """[(wrapper, launches, {variant: launches})] recorded between the two."""
    out = []
    for w, (n, var) in after.items():
        n0, var0 = before.get(w, (0, {}))
        dv = {k: v - var0.get(k, 0) for k, v in var.items() if v != var0.get(k, 0)}
        if n != n0 or dv:
            out.append((w, n - n0, dv))
    return out


def _advance(delta: list, sign: int = 1) -> None:
    for w, n, dv in delta:
        w.launches += sign * n
        for k, v in dv.items():
            w.variant_launches[k] += sign * v


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


class _Signature:
    """One signature's static inputs and, on CUDA, its graph and outputs."""

    def __init__(self, inputs):
        self.inputs = inputs      # static input tree
        self.graph = None         # torch.cuda.CUDAGraph on CUDA
        self.outputs = None       # the graph's output tree
        self.launches = []        # [(wrapper, launches, {variant: n})] a replay adds


class CompiledStep:
    """``step(state, *inputs) -> (state, *outputs)`` as one CUDA graph a
    signature on ``device`` (on the CPU: the same bookkeeping, the step
    called directly). ``donate=True`` takes the caller's state tensors as
    the static buffers (they are consumed: they hold the latest state from
    then on); ``donate=False`` copies them, and reading ``state`` returns a
    copy. Assigning ``state`` copies the tree into the static buffers (a
    tree of another layout replaces them and sets every signature up
    again).

    >>> cs = CompiledStep(chain.step, chain.init_state(), device="cuda")
    >>> audio, aux = cs(iq, words, modes)      # the graph's tensors
    """

    def __init__(self, step, state, *, device, donate: bool = True, name: str | None = None):
        self.step = step
        self.name = name or getattr(step, "__qualname__", None) or repr(step)
        self.device = resolve(device)
        self.donate = bool(donate)
        self._sigs: dict = {}
        self._generation = _generation
        self.signatures = 0  # signatures set up (again after invalidate or a new layout)
        self.captures = 0    # CUDA graphs captured
        self.replays = 0     # CUDA graph replays
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

    def _outputs(self, outs, sig: _Signature):
        """The step's outputs, a tensor that shares memory with the static
        state or inputs cloned (the next block would overwrite it)."""
        stores = {_storage(t) for t in leaves(self._state) + leaves(sig.inputs)
                  if isinstance(t, torch.Tensor)}
        return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                        and _storage(t) in stores else t, outs)

    def _run(self, sig: _Signature):
        out = self.step(self._state, *sig.inputs)
        if not isinstance(out, tuple) or len(out) < 1:
            raise TypeError(f"{self.name}: a step returns (state, *outputs)")
        new_state, outs = out[0], out[1:]
        outs = self._outputs(outs, sig)
        self._write_back(new_state)
        return outs

    def _setup(self, key, inputs) -> _Signature:
        """A new signature: static inputs holding ``inputs`` and, on CUDA,
        the captured graph; kept once it is whole."""
        static = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                          if isinstance(t, torch.Tensor) else t, inputs)
        sig = _Signature(static)
        self.signatures += 1
        self._copy_inputs(sig, inputs)
        if self.device.type == "cuda":
            self._capture(sig)
        self._sigs[key] = sig
        return sig

    def _copy_inputs(self, sig: _Signature, inputs) -> None:
        with span("compiled.inputs") as sp:
            pairs = [(d, s) for d, s in zip(leaves(sig.inputs), leaves(inputs))
                     if isinstance(d, torch.Tensor)]
            for dst, src in pairs:
                dst.copy_(src)
            if sp:
                sp.nbytes = sum(s.nbytes for _, s in pairs)
                sp.count = sum(s.device.type != self.device.type for _, s in pairs)

    def _capture(self, sig: _Signature) -> None:
        """Warm up on a copy of the state, then capture the step and the
        state's copy-back."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(clone_tree(self._state), *sig.inputs)
        cur.wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = self._run(sig)
        except Exception as e:
            _advance(_delta(before, _counts()), -1)
            raise RuntimeError(f"CompiledStep({self.name}): the step refused CUDA graph "
                               f"capture at {_refusal(e)}") from e
        sig.launches = _delta(before, _counts())
        _advance(sig.launches, -1)  # recorded, not launched
        sig.graph, sig.outputs = graph, outs
        self.captures += 1

    def __call__(self, *inputs):
        """One block: returns the step's outputs after the state."""
        if self._generation != _generation:
            self._sigs.clear()
            self._generation = _generation
        with span("compiled.call"), torch.no_grad():
            key = _spec(inputs)
            sig = self._sigs.get(key)
            if sig is None:
                with span("compiled.capture") as sp:
                    sig = self._setup(key, inputs)
                    if sp:
                        sp.count = self.signatures
            else:
                self._copy_inputs(sig, inputs)
            if self.device.type != "cuda":
                with span("compiled.run"):
                    outs = self._run(sig)
            else:
                with span("compiled.replay"):
                    sig.graph.replay()
                    _advance(sig.launches)
                self.replays += 1
                outs = sig.outputs
            self.blocks += 1
            return outs
