"""Guards on the port's boundaries: no JAX behind radioframe_torch or
chip_smoke.py, the reference host modules it reuses stay JAX-free, the K1
wrapper's CPU route, the explicit device, and the RxConfig options the port
does not carry yet."""

import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from radioframe.core.config import CicStage, FirStage, RxConfig
from radioframe_torch.api.radio import Radio
from radioframe_torch.device import resolve
from radioframe_torch.pipelines.rx_chain import RxChain

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = RxConfig(fs_in=1_536_000.0, channels=128,
                    stages=(CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
                    ols_hop=512, fuse_frontend=True, fuse_frontend_depth=2,
                    enabled_modes=(0, 1, 2, 3))


def _python(code: str, cwd=ROOT, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this guard checks the no-card behaviour")


@pytest.mark.parametrize("module", [
    "radioframe_torch.api.radio",
    "radioframe_torch.convert",
    "chip_smoke",
])
def test_import_pulls_in_no_jax(module):
    code = (f"import sys, {module}\n"
            "from radioframe_torch.pipelines.rx_chain import RxChain\n"
            "from radioframe.core.config import CicStage, FirStage, RxConfig\n"
            "RxChain(RxConfig(fs_in=1_536_000.0, channels=128, stages=(CicStage(R=8, N=4),"
            " FirStage(R=4, numtaps=97, passband_hz=15_000.0)), fuse_frontend=True,"
            " fuse_frontend_depth=2))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
            "assert not bad, bad\n"
            "print('ok')")
    out = _python(code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_reused_reference_host_modules_are_jax_free():
    code = ("import sys\n"
            "import radioframe.core.config, radioframe.ops.filter_design\n"
            "import radioframe.io.fixtures, radioframe.diag.metrics, radioframe.golden.model\n"
            "assert 'jax' not in sys.modules\n"
            "print('ok')")
    out = _python(code)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_kernel_wrapper_takes_plain_route_on_cpu():
    chain = RxChain(dataclasses.replace(FLAGSHIP, channels=2))
    T = chain.min_block
    st = chain.init_state()
    st, audio, _ = chain.step(st, torch.ones((2, T), dtype=torch.complex64),
                              torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32))
    assert audio.shape == (2, T // 32) and bool(torch.isfinite(audio).all())
    assert chain.fused.launches == 0


def test_device_is_explicit():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Radio(FLAGSHIP, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve("meta")
    with pytest.raises(TypeError):
        Radio(FLAGSHIP)  # no default device
    assert resolve("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("change,match", [
    (dict(fuse_frontend_depth=1), "K2"),
    (dict(stages=(CicStage(R=8, N=4), FirStage(R=3, numtaps=97, passband_hz=15_000.0)),
          fs_in=1_152_000.0), "K2"),
    (dict(fuse_backend=True), "K6"),
    (dict(emit_spectrum=True), "emit_spectrum"),
    (dict(nb_enabled=True), "nb_enabled"),
    (dict(nr_enabled=True), "nr_enabled"),
    (dict(notch_enabled=True), "notch_enabled"),
    (dict(vad_enabled=True), "vad_enabled"),
    (dict(nfm_deemphasis_s=531e-6), "nfm_deemphasis_s"),
    (dict(squelch_enabled=True), "squelch_enabled"),
])
def test_unported_options_raise(change, match):
    with pytest.raises(NotImplementedError, match=match):
        RxChain(dataclasses.replace(FLAGSHIP, **change))


def test_radio_unported_methods_raise():
    r = Radio(dataclasses.replace(FLAGSHIP, channels=2), device="cpu")
    for call in (r.waterfall, lambda: r.snap(0), lambda: r.save("x"), lambda: r.load("x")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_chip_smoke_fails_without_card():
    _no_card()
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available() is false" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and '"ok"' not in out.stdout
