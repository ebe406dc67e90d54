"""Stream-state checkpoint and resume (counterpart of
``radioframe/core/checkpoint.py``).

The whole state tree of a chain (NCO accumulators, decimator tails, AGC
envelopes, demod carries) is saved at block-epoch boundaries; restoring it
continues the stream bit-exactly. Epochs are directories ``epoch_{:012d}``
under one directory, as the reference's are. The reference stores through
orbax; this package has its own on-disk format for the same tree: one
``state.npz`` per epoch holding the tree's leaves in order
(``leaf_00000``, ...), its structure as JSON (``__tree__``: dicts by key,
tuples in order, ``()`` for a disabled feature) and the schema version
(``__version__``; absent in an unversioned round-1 snapshot). No pickle is
written or read.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from radioframe_torch.convert import state_to_numpy

# State-schema version, bumped when the chain state tree's layout changes.
# v1 = round-1 layout (scalar AGC envelope, no deemph/eq keys); v2 =
# round-2 (AgcBank {hist, env, lpf} dict, deemph/eq feature keys).
CURRENT_VERSION = 2
_FILE = "state.npz"


def _migrate_v1_to_v2(state):
    """Round-1 -> round-2 layout for default-config chains.

    - RX 'agc' scalar envelope -> AgcBank {hist: (), env, lpf: 0} (lpf is
      inert at the v1-default instant attack, so zeros resume bit-exactly)
    - RX gains 'deemph': (), TX gains 'eq': () (features default-disabled).
    """
    def walk(d):
        if not isinstance(d, dict):
            return d
        d = {k: walk(v) for k, v in d.items()}
        if "agc" in d and not isinstance(d["agc"], dict):
            env = np.asarray(d["agc"])
            d["agc"] = {"hist": (), "env": env, "lpf": np.zeros_like(env)}
            d.setdefault("deemph", ())
        if "comp" in d and "ssb" in d:  # a TxChain state
            d.setdefault("eq", ())
        return d

    return walk(state)


MIGRATIONS = {1: _migrate_v1_to_v2}


def _flatten(tree, leaves: list):
    """(the tree's structure as JSON-able data, with its leaves appended to
    ``leaves`` in order)."""
    if isinstance(tree, dict):
        return {"d": {k: _flatten(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {"t": [_flatten(v, leaves) for v in tree]}
    leaves.append(np.asarray(tree))
    return {"l": len(leaves) - 1}


def _unflatten(spec, leaves):
    if "d" in spec:
        return {k: _unflatten(v, leaves) for k, v in spec["d"].items()}
    if "t" in spec:
        return tuple(_unflatten(v, leaves) for v in spec["t"])
    return leaves[spec["l"]]


def write_tree(path: str, tree, version: int | None) -> None:
    """Write ``tree`` (numpy or torch leaves) to ``path``/state.npz;
    ``version=None`` writes an unversioned (round-1) snapshot."""
    os.makedirs(path, exist_ok=True)
    leaves: list = []
    spec = _flatten(state_to_numpy(tree), leaves)
    arrays = {f"leaf_{i:05d}": a for i, a in enumerate(leaves)}
    arrays["__tree__"] = np.array(json.dumps(spec))
    if version is not None:
        arrays["__version__"] = np.array(version, np.int32)
    tmp = os.path.join(path, f".{_FILE}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(path, _FILE))  # a reader never sees a partial file


def read_tree(path: str):
    """(version or None, the tree with numpy leaves) from ``path``/state.npz."""
    with np.load(os.path.join(path, _FILE), allow_pickle=False) as z:
        spec = json.loads(str(z["__tree__"]))
        leaves = [z[f"leaf_{i:05d}"] for i in range(sum(k.startswith("leaf_") for k in z.files))]
        version = int(z["__version__"]) if "__version__" in z.files else None
    return version, _unflatten(spec, leaves)


def _like(ref, x, where: str = "state"):
    """``x`` (numpy leaves) in ``ref``'s structure, each leaf with the dtype,
    shape and device of ``ref``'s (a torch tensor or a numpy array)."""
    if isinstance(ref, dict):
        if not isinstance(x, dict) or set(x) != set(ref):
            raise ValueError(f"checkpoint {where}: keys {sorted(x) if isinstance(x, dict) else x!r}"
                             f" do not match {sorted(ref)}")
        return {k: _like(ref[k], x[k], f"{where}.{k}") for k in ref}
    if isinstance(ref, (tuple, list)):
        if not isinstance(x, (tuple, list)) or len(x) != len(ref):
            raise ValueError(f"checkpoint {where}: {len(ref)} entries expected")
        return tuple(_like(r, v, f"{where}[{i}]") for i, (r, v) in enumerate(zip(ref, x)))
    x = np.asarray(x)
    if tuple(x.shape) != tuple(ref.shape):
        raise ValueError(f"checkpoint {where}: shape {x.shape} != {tuple(ref.shape)}")
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(np.array(x, copy=True)).to(device=ref.device, dtype=ref.dtype)
    return np.asarray(x, dtype=ref.dtype)


class StreamCheckpointer:
    """Epoch-numbered state snapshots under a directory, schema-versioned."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:012d}")

    def save(self, epoch: int, state, version: int = CURRENT_VERSION) -> str:
        path = self._path(epoch)
        write_tree(path, state, version)
        return path

    def epochs(self):
        pat = re.compile(r"^epoch_(\d{12})$")
        out = []
        for name in os.listdir(self.directory):
            m = pat.match(name)
            if m and os.path.isfile(os.path.join(self.directory, name, _FILE)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_epoch(self):
        eps = self.epochs()
        return eps[-1] if eps else None

    def restore_epoch(self, like, epoch: int | None = None):
        """(epoch, ``restore(epoch, like)``), the latest epoch by default;
        FileNotFoundError if the directory holds none."""
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return epoch, self.restore(epoch, like)

    def restore(self, epoch: int, like, migrations=None):
        """Restore epoch's state in the structure of ``like``, each leaf with
        the dtype, shape and device of ``like``'s.

        Older-schema checkpoints (unversioned round-1 snapshots included) are
        migrated forward through ``MIGRATIONS`` first."""
        version, st = read_tree(self._path(epoch))
        v = 1 if version is None else version
        migrations = MIGRATIONS if migrations is None else migrations
        while v < CURRENT_VERSION:
            if v not in migrations:
                raise ValueError(f"no migration from state-schema v{v}")
            st = migrations[v](st)
            v += 1
        return _like(like, st)


def save_on_rank0(ck: StreamCheckpointer, epoch: int, tree, mesh) -> str:
    """Rank 0 of ``mesh``'s group writes ``tree`` (global, the same on every
    rank) as ``epoch``; then every rank meets at a barrier, so that a load
    after the save reads the whole file. Returns the epoch's path."""
    import torch.distributed as dist

    if mesh.rank == 0:
        ck.save(epoch, tree)
    dist.barrier()
    return ck._path(epoch)
