"""Save and load under a mesh, and the hybrid mesh, in one spawn of four
gloo ranks on the CPU (rank bodies in tests/torch_shard_ranks.py).

- ``Radio(mesh=(1, 4))`` (depth-1 front end with the rdma halo: K2 and K7's
  plain routes) and ``Monitor(mesh=(1, 4))`` in the ``emit_env`` form and
  in the two-kernel form with hang AGC (the hang history's spec, which the
  reference drops: R2) run two blocks, save, and run two more; a fresh
  object that loads the checkpoint runs the same two blocks bit-equal.
- Cross-loading: the mesh's checkpoint loads into an unsharded object, and
  an unsharded object's checkpoint loads under the mesh; each continues
  within 2e-4 of the other's stream (audio; NFM rows modulo fs/deviation,
  an atan2 branch flip), and the frequencies and modes come back.
- ``make_hybrid_mesh(1, 2)`` with LOCAL_WORLD_SIZE=2 (two "hosts" of two
  ranks): the (2, 2) layout of the reference's host-major formula
  (``radioframe/shard/mesh.py:58-62``), a refused size, and one
  ``ShardedRxChain`` step on it bit-equal to the step on ``make_mesh(2,
  2)``; and, in a fresh interpreter, the ``env://`` initialisation."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from radioframe_torch.api.monitor import Monitor
from radioframe_torch.api.radio import NAME_BY_MODE, Radio
from radioframe_torch.core.config import RxConfig
from radioframe_torch.shard.mesh import spawn

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
RANKS_TIMEOUT_S = 240.0
TOL = 2e-4
C, M = 8, 64
RADIO_CFG = RxConfig(channels=C, ols_hop=512, fuse_frontend=True, fuse_frontend_depth=1,
                     halo_transport="rdma")
FREQS = np.linspace(-80e3, 80e3, C)
RADIO_MODES = (np.arange(C) % 6).astype(np.int32)
NFM_PERIOD = {"radio": 19.2, "monitor": 6.0}  # fs_audio / deviation
BASE = dict(fs_in=15_000.0 * M, num_channels=M, emit_spectrum=True, waterfall_from_pfb=True,
            waterfall_frame_avg=4, fuse_pfb=True, fuse_demod=True)
HANG = (dict(release_s=0.5, attack_s=0.002, hang_s=0.01), dict(release_s=0.25, hang_s=0.005),
        dict(release_s=0.8, attack_s=0.005, hang_s=0.02), dict(),
        dict(release_s=0.5, attack_s=0.002, hang_s=0.01), dict(release_s=0.8, hang_s=0.02))
MONITORS = {
    "monitor emit_env": (dict(BASE, fuse_single_pass=True, enabled_modes=(0, 1, 3)),
                         np.array([0, 1, 3])[np.arange(M) % 3].astype(np.int32)),
    "monitor two-kernel hang": (dict(BASE, agc_modes=HANG, enabled_modes=(0, 1, 2, 3)),
                                (np.arange(M) % 4).astype(np.int32)),
}


def _radio_blocks():
    rng = np.random.default_rng(21)
    T = 4 * Radio(RADIO_CFG, device="cpu").chain.min_block
    return [(rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
            for _ in range(4)]


def _monitor_blocks():
    rng = np.random.default_rng(22)
    return [(rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
            for _ in range(4)]


def _unsharded(kind, cfg, controls):
    import torch_shard_ranks  # tests/ is on the path

    return torch_shard_ranks._api_object(kind, cfg, controls, None)


def _close(got, want, modes, kind):
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    nfm = modes == 3
    p = NFM_PERIOD[kind]
    d[nfm] = (d[nfm] + p / 2) % p - p / 2
    assert float(np.abs(d).max()) <= TOL


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(the ranks' results, the unsharded runs): each case's unsharded
    object runs blocks 0-1, saves, and runs 2-3 before the spawn."""
    import torch_shard_ranks

    cases, unsharded = [], {}
    specs = [("radio", "radio", RADIO_CFG, _radio_blocks(), (FREQS, RADIO_MODES))]
    specs += [(name, "monitor", cfg, _monitor_blocks(), modes)
              for name, (cfg, modes) in MONITORS.items()]
    for name, kind, cfg, blocks, controls in specs:
        d = tmp_path_factory.mktemp(name.replace(" ", "_"))
        obj = _unsharded(kind, cfg, controls)
        for b in blocks[:2]:
            obj.process(b)
        obj.save(str(d / "unsharded"), epoch=3)
        unsharded[name] = {"cont": [obj.process(b) for b in blocks[2:]], "dir": d,
                           "kind": kind, "cfg": cfg, "blocks": blocks, "controls": controls}
        cases.append((name, kind, cfg, blocks, controls, str(d / "sharded"),
                      str(d / "unsharded")))
    rng = np.random.default_rng(23)
    T = 4 * Radio(RADIO_CFG, device="cpu").chain.min_block
    block = (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T))).astype(np.complex64)
    hybrid = (RxConfig(channels=C, ols_hop=512), block, FREQS, RADIO_MODES)
    ranks = spawn(torch_shard_ranks.checkpoint_cases, 4, cases, hybrid,
                  timeout_s=RANKS_TIMEOUT_S)
    return ranks, unsharded


@pytest.mark.parametrize("name", ["radio", *MONITORS])
def test_resume_under_mesh_is_bit_exact(results, name):
    got = results[0][0][name]
    assert got["epochs"] == [1, 3]
    assert os.path.isfile(os.path.join(got["path"], "state.npz"))
    for a, b in zip(got["cont"], got["resumed"]):
        assert np.array_equal(a, b) and np.isfinite(a).all()


@pytest.mark.parametrize("name", ["radio", *MONITORS])
def test_cross_load_with_an_unsharded_object(results, name):
    """The mesh's checkpoint in an unsharded object, and the unsharded
    object's under the mesh, each continuing within 2e-4 of the other."""
    got, ref = results[0][0][name], results[1][name]
    kind, controls = ref["kind"], ref["controls"]
    modes = controls[1] if kind == "radio" else controls
    want_controls = ([float(f) for f in controls[0]], [NAME_BY_MODE[int(m)] for m in modes]) \
        if kind == "radio" else [NAME_BY_MODE[int(m)] for m in modes]
    assert got["controls"] == [want_controls, want_controls]
    for a, b in zip(got["cross"], ref["cont"]):
        _close(a, b, modes, kind)
    obj = _unsharded(kind, ref["cfg"], np.zeros_like(controls))
    assert obj.load(str(ref["dir"] / "sharded")) == 1
    for b, want in zip(ref["blocks"][2:], got["cont"]):
        _close(obj.process(b), want, modes, kind)


def test_hybrid_mesh_layout_and_step(results):
    """Host-major (2, 2) over two hosts of two ranks, as the reference's
    fallback sorts devices by (process_index, id) and reshapes (n_hosts,
    channel_per_host, time) into (n_hosts * channel_per_host, time)."""
    n_hosts, cph, time = 2, 1, 2
    order = sorted(range(4), key=lambda r: (r // 2, r))  # (process_index, id) of rank r
    ref = np.asarray(order).reshape(n_hosts, cph, time).reshape(n_hosts * cph, time)
    for rank, r in enumerate(results[0]):
        h = r["hybrid"]
        assert h["shape"] == {"channel": 2, "time": 2} and h["device"] == "cpu"
        assert tuple(np.argwhere(ref == rank)[0]) == h["index"]
        assert h["refused"] and h["equal"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_hybrid_mesh_initialises_from_env():
    code = ("import torch.distributed as dist\n"
            "from radioframe_torch.shard.mesh import make_hybrid_mesh\n"
            "m = make_hybrid_mesh(1, 1, device='cpu')\n"
            "assert dist.is_initialized() and dist.get_backend() == 'gloo'\n"
            "assert m.shape == {'channel': 1, 'time': 1}\n"
            "try:\n"
            "    make_hybrid_mesh(2, 1, device='cpu', init_distributed=False)\n"
            "except ValueError as e:\n"
            "    print('refused:', e)\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), RANK="0", WORLD_SIZE="1", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), GLOO_SOCKET_IFNAME="lo")
    env.pop("LOCAL_RANK", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "refused: hybrid mesh (1 hosts x 2, 1) needs 2 ranks" in out.stdout
