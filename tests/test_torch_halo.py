"""The port's time-axis halo exchange and cross-shard scan completion
(``radioframe_torch/shard/halo.py``, K7's ``kernels/halo_dma.py``) against
the JAX package's ``shard/halo.py`` and ``kernels/halo_dma.py``.

The port runs as four spawned gloo ranks on the CPU (one ``spawn`` for every
case, file rendezvous, with a timeout); K7 takes its plain route there, the
ppermute transport. The references run under ``shard_map`` on four of the
conftest's eight CPU devices, K7 as the Pallas kernel in interpret mode.
Halos move data only and are held bit-equal; the scans and carry chains
sum in another order (log-step scans against ``associative_scan``) and are
held to 1e-5 of their scale."""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from radioframe.kernels.halo_dma import causal_halo_dma, ring_halo_dma
from radioframe.shard import halo as jhalo
from radioframe_torch.shard.mesh import spawn

D, C, T_LOC = 4, 2, 16
T = D * T_LOC
TOL = 1e-5
RANKS_TIMEOUT_S = 180.0
AFF_TABLE = (0.95, 0.99, 0.999)
REL_TABLE = (0.99, 0.995, 0.999)

_rng = np.random.default_rng(41)


def _c64(*shape):
    return (_rng.standard_normal(shape) + 1j * _rng.standard_normal(shape)).astype(np.complex64)


def _f32(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


# (name, kind, port args, output layouts): "t" a (C, T_local) block per rank
# (concatenated along time), "s" a per-rank value stacked over ranks, "r" a
# value replicated on every rank
_X_C, _C_C = _c64(C, T), _c64(C, 4)
_X_F, _C_F = _f32(C, T), _f32(C, 3)
_FIN, _A, _CARRY = _f32(D, C), np.float32(0.9), _f32(C)
_B, _V = _f32(C, T), np.abs(_f32(C, T))
_A_CH = np.asarray(AFF_TABLE, np.float32)[np.arange(C) % 3]
_IDX = (np.arange(C) % 3).astype(np.int64)
_REL_CH = np.asarray(REL_TABLE, np.float32)[_IDX]
CASES = [
    ("causal_halo c64 H=4", "causal_halo", (_X_C, _C_C, 4), "tr"),
    ("causal_halo f32 H=3", "causal_halo", (_X_F, _C_F, 3), "tr"),
    ("causal_halo H=0", "causal_halo", (_X_F, _C_F[:, :0], 0), "tr"),
    ("causal_halo_dma c64 H=4", "causal_halo_dma", (_X_C, _C_C, 4), "tr"),
    ("causal_halo_dma f32 H=3", "causal_halo_dma", (_X_F, _C_F, 3), "tr"),
    ("causal_halo_dma ppermute_fallback", "causal_halo_dma_pp", (_X_C, _C_C, 4), "tr"),
    ("ring_halo_dma c64 H=4", "ring_halo_dma", (_X_C, 4), "t"),
    ("last_shard_value", "last_shard_value", (_X_F,), "r"),
    ("affine_carry_chain", "affine_carry_chain", (_FIN, _A, _CARRY), "sr"),
    ("max_carry_chain", "max_carry_chain", (np.abs(_FIN), _A, np.abs(_CARRY)), "sr"),
    ("sharded_affine_scan scalar", "sharded_affine_scan", (0.995, _B, _CARRY, None), "tr"),
    ("sharded_affine_scan per channel", "sharded_affine_scan", (_A_CH, _B, _CARRY, None), "tr"),
    ("sharded_affine_scan table", "sharded_affine_scan", (_A_CH, _B, _CARRY, AFF_TABLE), "tr"),
    ("sharded_maxdecay_scan", "sharded_maxdecay_scan",
     (_REL_CH, _V, np.abs(_CARRY), None, None), "tr"),
    ("sharded_maxdecay_scan table+index", "sharded_maxdecay_scan",
     (_REL_CH, _V, np.abs(_CARRY), REL_TABLE, _IDX), "tr"),
]


@pytest.fixture(scope="module")
def port():
    """Every case through the port's four ranks in one spawn: {name: [per
    output, the global value]}, and K7's launches per rank."""
    import torch_shard_ranks  # tests/ is on the path; the ranks import it too

    ranks = spawn(torch_shard_ranks.halo_cases, D, [c[:3] for c in CASES],
                  timeout_s=RANKS_TIMEOUT_S)
    out = {}
    for name, _, _, layout in CASES:
        vals = []
        for i, kind in enumerate(layout):
            per = [r[name][i] for r in ranks]
            if kind == "t":
                vals.append(np.concatenate(per, axis=-1))
            elif kind == "s":
                vals.append(np.stack(per))
            else:
                for p in per[1:]:
                    np.testing.assert_array_equal(p, per[0], err_msg=f"{name}: not replicated")
                vals.append(per[0])
        out[name] = vals
    return out, [r["__launches__"] for r in ranks]


def _jax(kind, args):
    """The reference's function for a case, under shard_map on D devices."""
    mesh = jax.make_mesh((D,), ("time",), devices=jax.devices()[:D])
    shard = functools.partial(jax.shard_map, mesh=mesh, check_vma=False)
    t, r = P(None, "time"), P(None, None)
    if kind.startswith("causal_halo"):
        x, carry, H = args
        fns = {"causal_halo": lambda c, x: jhalo.causal_halo(x, c, H, "time"),
               "causal_halo_dma": lambda c, x: causal_halo_dma(x, c, H, "time", interpret=True),
               "causal_halo_dma_pp": lambda c, x: causal_halo_dma(
                   x, c, H, "time", interpret=True, ppermute_fallback=True)}
        f = shard(fns[kind], in_specs=(r, t), out_specs=(t, r))
        return jax.jit(f)(jnp.asarray(carry), jnp.asarray(x))
    if kind == "ring_halo_dma":
        x, H = args
        f = shard(lambda x: ring_halo_dma(x, H, "time", interpret=True), in_specs=(t,),
                  out_specs=t)
        return (jax.jit(f)(jnp.asarray(x)),)
    if kind == "last_shard_value":
        f = shard(lambda x: jhalo.last_shard_value(x[:, -1], "time"), in_specs=(t,),
                  out_specs=P(None))
        return (jax.jit(f)(jnp.asarray(args[0])),)
    if kind.endswith("carry_chain"):
        fin, A, carry = args
        combine = (lambda b, p: b + p) if kind.startswith("affine") else jnp.maximum

        def body(fin, c):
            my_in, out = jhalo._carry_chain(fin[0], jnp.float32(A), c, "time", combine)
            return my_in[None], out

        f = shard(body, in_specs=(P("time", None), P(None)), out_specs=(P("time", None), P(None)))
        return jax.jit(f)(jnp.asarray(fin), jnp.asarray(carry))
    if kind == "sharded_affine_scan":
        a, b, carry, table = args
        a_j = a if np.ndim(a) == 0 else jnp.asarray(a)
        f = shard(lambda b, c: jhalo.sharded_affine_scan(a_j, b, c, "time", a_table=table),
                  in_specs=(t, P(None)), out_specs=(t, P(None)))
        return jax.jit(f)(jnp.asarray(b), jnp.asarray(carry))
    a, v, carry, table, idx = args
    idx_j = None if idx is None else jnp.asarray(idx, jnp.int32)
    f = shard(lambda v, c: jhalo.sharded_maxdecay_scan(jnp.asarray(a), v, c, "time",
                                                      a_table=table, a_index=idx_j),
              in_specs=(t, P(None)), out_specs=(t, P(None)))
    return jax.jit(f)(jnp.asarray(v), jnp.asarray(carry))


@pytest.mark.parametrize("name,kind,args,layout", CASES, ids=[c[0] for c in CASES])
def test_matches_reference(port, name, kind, args, layout):
    got = port[0][name]
    want = [np.asarray(w) for w in _jax(kind, args)]
    assert len(got) == len(want) == len(layout)
    exact = kind.startswith(("causal", "ring", "last"))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL * scale)


def test_k7_takes_its_plain_route_on_cpu(port):
    """On CPU tensors K7's wrapper runs the ppermute transport: no launch."""
    assert port[1] == [0] * D


def test_rank_module_imports_no_jax():
    """The ranks import tests/torch_shard_ranks.py; it must not pull in JAX."""
    root = Path(__file__).resolve().parents[1]
    code = ("import sys, torch_shard_ranks\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'radioframe'))\n"
            "print(','.join(bad) or 'clean')")
    env = dict(os.environ, PYTHONPATH=str(root))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=root / "tests", capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr[-2000:]


# --- the launcher -------------------------------------------------------------------------


def test_spawn_fails_on_a_failing_rank_and_stops_every_rank():
    """A rank that raises fails the call with its traceback, although the
    other ranks hang in a barrier; no rank outlives the call."""
    import multiprocessing

    import torch_shard_ranks

    with pytest.raises(RuntimeError, match=r"rank 1 failed(.|\n)*ValueError: rank 1 was told"):
        spawn(torch_shard_ranks.fail_on_rank1, 2, timeout_s=RANKS_TIMEOUT_S)
    assert multiprocessing.active_children() == []


class _Proc:
    def __init__(self, exitcode):
        self.exitcode = exitcode


def test_collect_times_out_and_reports_a_silent_exit():
    """The parent's wait: a rank that never reports fails the call at the
    timeout; a rank that exited without a result fails it too."""
    import queue as queue_mod

    from radioframe_torch.shard.mesh import _collect

    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\]"):
        _collect([_Proc(None), _Proc(None)], queue_mod.Queue(), timeout_s=0.5)
    q = queue_mod.Queue()
    q.put((0, True, "done"))
    with pytest.raises(RuntimeError, match="rank 1 exited with code -9"):
        _collect([_Proc(0), _Proc(-9)], q, timeout_s=60.0)
