"""The block path under ``Radio``, ``Monitor`` and ``Transceiver``: the one
place where an API object's block is staged, stepped and handed its
controls.

``BlockObject`` owns the captured step (``CompiledStep``, ``donate=False``)
or, under a mesh, the rank's state and the sharded chain; the object's own
stream (``Stager(own_stream=True)``: objects driven from several threads
run side by side on one card); ``last_aux``; the ``state`` the next block
starts from; and the checkpoint's two ways (a file, or under a mesh rank 0
writing the gathered state).

The controls are the per-channel inputs an API object computes on the host
each block (tuning words, modes). ``_mirror`` hands each to the step one
way: one device tensor for the object's life, made at its first block, so
the captured step stays bound to it (a new tensor would be a new binding:
a capture); each block the host arrays it is made from are compared with
those of its last copy, and only a change is copied, in place, on the
object's stream. No flag marks a change, so a write straight into a host
array (``trx._modes[:] = 0``) reaches the next block as a setter's does.
"""

from __future__ import annotations

import numpy as np
import torch

from radioframe_torch.core.checkpoint import StreamCheckpointer, save_on_rank0
from radioframe_torch.core.compiled import CompiledStep, clone_tree
from radioframe_torch.core.stream import Stager
from radioframe_torch.diag.timing import span
from radioframe_torch.shard.mesh import gather_state, shard_state


class BlockObject:
    """``chain`` stepped a block at a time on ``device`` from ``state``:
    through a ``CompiledStep`` named ``<class>.process``, or under ``mesh``
    by ``sharded(chain, mesh)`` from this rank's part of ``state``. A
    subclass gives ``_controls()`` (its control tensors, from ``_mirror``)
    and, with a mesh, ``_shard_block(*arrays)``."""

    def __init__(self, chain, state, *, device, mesh=None, sharded=None):
        self.device, self.chain, self.mesh = device, chain, mesh
        self.sharded = None  # the sharded chain under a mesh
        self._compiled = None  # the captured step without a mesh
        if mesh is not None:
            if mesh.device.type != device.type:
                raise ValueError(f"mesh on {mesh.device}, {type(self).__name__} on {device}")
            self.sharded = sharded(chain, mesh)
            self._state = shard_state(state, self.sharded.state_specs(), mesh)
        else:
            # the reference's jax.jit(_step_planes): one graph a block signature
            self._compiled = CompiledStep(chain.step, state, device=device, donate=False,
                                          name=f"{type(self).__name__}.process")
        self.last_aux = None
        self._mirrors: dict = {}  # name -> (sources' bytes at the last copy, tensors)
        self._stager = Stager(device, own_stream=True)

    @property
    def state(self) -> dict:
        """The chain state after the last block (a copy of the captured
        step's buffers; under a mesh, the rank's part)."""
        return self._state if self._compiled is None else self._compiled.state

    @state.setter
    def state(self, tree) -> None:
        """Seen by the next block: copied into the captured step's buffers."""
        if self._compiled is None:
            self._state = tree
        else:
            with self._stager.running():
                self._compiled.state = tree

    def global_state(self) -> dict:
        """The whole chain state: ``state`` itself, or under a mesh the
        ranks' parts joined on every rank (a collective)."""
        if self.mesh is None:
            return self.state
        return gather_state(self.state, self.sharded.state_specs(), self.mesh)

    def close(self) -> None:
        """Free the sharded chain's buffers where it keeps any (the sharded
        RX chain's halo buffers: a collective over the time axis)."""
        close = getattr(self.sharded, "close", None)
        if close is not None:
            close()

    # -- the block ---------------------------------------------------------------

    def _mirror(self, name: str, *sources: np.ndarray, derive=None):
        """Control ``name`` on the device: ``derive(*sources)`` (by default
        the one source) in tensors kept from the first call on. Copied, in
        place on the current stream, only where the sources' bytes differ
        from the last copy's. A tensor, or a tuple where ``derive`` returns
        one."""
        key = [s.tobytes() for s in sources]
        seen = self._mirrors.get(name)
        if seen is not None and seen[0] == key:
            return seen[1]
        host = derive(*sources) if derive is not None else sources[0]
        one = not isinstance(host, tuple)
        host = [torch.from_numpy(np.ascontiguousarray(h)) for h in ((host,) if one else host)]
        dev = (tuple(torch.empty_like(h, device=self.device) for h in host) if seen is None
               else ((seen[1],) if one else seen[1]))
        cuda = self.device.type == "cuda"
        for d, h in zip(dev, host):
            # from page-locked memory, which the caching allocator keeps
            # until the copy is done: no wait for the stream's earlier work
            d.copy_(h.pin_memory() if cuda else h, non_blocking=cuda)
        self._mirrors[name] = (key, dev[0] if one else dev)
        return self._mirrors[name][1]

    def _block(self, blocks, finish=None):
        """One block inside the ``api.process`` root span, on the object's
        stream: the controls mirrored, ``blocks`` ((host array, dtype)
        pairs) staged, the step called with both and its aux kept; returns
        ``finish(*outputs)`` (the outputs before the aux; by default the one
        output to the host), under a mesh ``_shard_block(*arrays)``."""
        with span("api.process", root=True) as sp, self._stager.running():
            if sp:
                sp.stream = self._stager.stream_id()
            if self.mesh is not None:
                return self._shard_block(*(a for a, _ in blocks))
            controls = self._controls()
            xs = [self._stager.to_device(a, dtype) for a, dtype in blocks]
            *outs, aux = self._compiled(*xs, *controls)
            self.last_aux = clone_tree(aux)  # the next replay overwrites the graph's own
            return self._stager.to_host(*outs) if finish is None else finish(*outs)

    # -- persistence -------------------------------------------------------------

    def _save(self, directory: str, epoch: int, **controls) -> str:
        """Write ``{"state": global state, **controls}`` as ``epoch``; under
        a mesh (a collective) rank 0 writes and every rank waits for it."""
        ck = StreamCheckpointer(directory)
        payload = {"state": self.global_state(), **controls}
        if self.mesh is None:
            return ck.save(epoch, payload)
        return save_on_rank0(ck, epoch, payload, self.mesh)

    def _restore(self, directory: str, epoch: int | None, init_state, **controls) -> int:
        """Read ``epoch`` (the latest by default) in the layout of
        ``init_state`` and ``controls``: the state (under a mesh, this
        rank's part of it), and each host control array in place."""
        like = {"state": init_state, **controls}
        epoch, restored = StreamCheckpointer(directory).restore_epoch(like, epoch)
        state = restored["state"]
        self.state = (state if self.mesh is None
                      else shard_state(state, self.sharded.state_specs(), self.mesh))
        for k, arr in controls.items():
            arr[:] = restored[k]
        return epoch
