"""The port's CLI (``python -m radioframe_torch.cli``) and its example
scripts, run as the user runs them: in subprocesses with ``--device cpu``,
the repository root put on PYTHONPATH by the test itself. Ported from the
CLI half of tests/test_stream_cli.py, with its bars: the decoded CW text
exact, the TX carrier's spectral peak within 50 Hz."""

import os
import select
import signal
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from radioframe_torch.io.wav import read_wav, write_wav
from radioframe_torch.ops.decoders import cw_encode_envelope

ROOT = Path(__file__).resolve().parents[1]
FS = 192_000.0
# each example script with the arguments that keep it small on the CPU ("{d}": the
# job's temporary directory)
EXAMPLES = {"torch_rx_demo": [], "torch_transceiver_demo": [], "torch_cat_tcp_demo": [],
            "torch_channelizer_demo": ["--channels", "32", "--frames", "2048",
                                       "--out", "{d}/wf.png"],
            "torch_duplex_demo": ["--seconds", "0.35"],
            "torch_golden_rx_demo": ["--seconds", "0.25", "--blocked"],
            "torch_monitor_demo": ["--mesh", "2", "--channels", "32"]}


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    env.pop("JAX_PLATFORMS", None)
    return env


def _cli(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "radioframe_torch.cli", *args], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=timeout)


def _cw_job(d):
    """A CW capture WAV, demodulated by ``rx`` (K1's plain route), then
    decoded by ``decode``."""
    env = cw_encode_envelope("CQ TEST", FS, wpm=25.0)
    n = ((len(env) // 8192) + 1) * 8192
    env = np.pad(env, (0, n - len(env)))
    t = np.arange(n) / FS
    iq = (env * np.exp(2j * np.pi * 7_000.0 * t)).astype(np.complex64)
    cap, out, wf = (str(d / f) for f in ("cap.wav", "audio.wav", "wf.npy"))
    write_wav(cap, iq, FS, scale=0.5)
    rx = _cli("rx", "--wav", cap, "--freq", "7000", "--mode", "cw", "--out", out,
              "--waterfall", wf, "--device", "cpu")
    return {"n": n, "out": out, "wf": wf, "rx": rx,
            "decode": _cli("decode", "--wav", out, "--tone", "600") if rx.returncode == 0
            else None}


def _tx_job(d):
    """A 1 kHz tone, AM-modulated by ``tx`` onto a +12 kHz carrier."""
    t = np.arange(4 * 2048) / 48_000.0
    wav_in, wav_out = str(d / "voice.wav"), str(d / "iq.wav")
    write_wav(wav_in, (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32), 48_000.0)
    return {"out": wav_out, "p": _cli("tx", "--wav", wav_in, "--freq", "12000", "--mode", "am",
                                      "--out", wav_out, "--device", "cpu")}


def _monitor_job(d, M):
    """A tone at channel 7's centre over a noise floor through ``monitor``."""
    fs = M * 15_000.0
    rng = np.random.default_rng(2)
    T = 32 * M * 8
    n = np.arange(T) / fs
    wide = (0.5 * np.exp(2j * np.pi * (7 * 15_000.0) * n)
            + 0.01 * (rng.standard_normal(T) + 1j * rng.standard_normal(T))).astype(np.complex64)
    wav, out, wf = d / "wide.wav", d / "ch7.wav", d / "wf.npy"
    write_wav(str(wav), wide, fs)
    return {"out": out, "wf": wf,
            "p": _cli("monitor", "--wav", str(wav), "--channels", str(M), "--mode", "am",
                      "--channel", "7", "--audio-out", str(out), "--waterfall", str(wf),
                      "--device", "cpu")}


def _no_card_job(d):
    cap = str(d / "cap.wav")
    write_wav(cap, np.ones(8192, np.complex64), FS)
    return _cli("rx", "--wav", cap, "--freq", "0", "--out", str(d / "a.wav"))


def _example(script, d):
    return subprocess.run([sys.executable, str(ROOT / "examples" / f"{script}.py"),
                           "--device", "cpu", *(a.format(d=d) for a in EXAMPLES[script])],
                          cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every command of the tests below, four subprocesses at a time (each
    spends seconds importing torch and scipy): {name: result}."""
    jobs = {"cw": _cw_job, "tx": _tx_job, "no card": _no_card_job,
            "info": lambda d: _cli("info", "--device", "cpu"),
            "demo": lambda d: _cli("demo", "--device", "cpu"),
            **{f"monitor {M}": (lambda d, M=M: _monitor_job(d, M)) for M in (32, 24)},
            **{s: (lambda d, s=s: _example(s, d)) for s in EXAMPLES}}
    with ThreadPoolExecutor(max_workers=4) as pool:
        futs = {k: pool.submit(fn, tmp_path_factory.mktemp(k.replace(" ", "_")))
                for k, fn in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def test_rx_and_decode_cw(runs):
    r = runs["cw"]
    assert r["rx"].returncode == 0, r["rx"].stderr[-2000:]
    assert "audio ->" in r["rx"].stdout and "on cpu" in r["rx"].stdout
    audio, fs = read_wav(r["out"])
    assert fs == 48_000.0 and len(audio) == r["n"] // 4
    assert np.load(r["wf"]).ndim == 2
    assert r["decode"].returncode == 0, r["decode"].stderr[-2000:]
    assert "CQ TEST" in r["decode"].stdout, r["decode"].stdout


def test_rx_refuses_a_missing_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card behaviour")
    p = runs["no card"]
    assert p.returncode != 0 and "no CUDA device" in p.stderr


def test_info(runs):
    """The FT8/WSPR lines of the reference's ``info``: each mode's stand-in
    tables named while they are PROVISIONAL."""
    from radioframe_torch.ops import ft8, wspr

    p = runs["info"]
    assert p.returncode == 0, p.stderr[-2000:]
    assert "default RX chain" in p.stdout
    for name, mod in (("FT8", ft8), ("WSPR", wspr)):
        line = next(ln for ln in p.stdout.splitlines() if ln.startswith(f"{name}:"))
        assert ("PROVISIONAL" in line) == mod.INTEROP_PROVISIONAL
        assert all(item in line for item in mod.PROVISIONAL_ITEMS)


def test_tx_roundtrip(runs):
    """tx: a mono audio WAV -> an IQ WAV at 4x the rate, the AM carrier at
    +12 kHz."""
    p = runs["tx"]["p"]
    assert p.returncode == 0, p.stderr[-2000:]
    iq, fs_iq = read_wav(runs["tx"]["out"])
    assert fs_iq == 4 * 48_000.0 and np.iscomplexobj(iq)
    X = np.abs(np.fft.fft(iq))
    f = np.fft.fftfreq(len(iq), 1.0 / fs_iq)
    assert abs(f[int(np.argmax(X))] - 12_000.0) < 50.0


@pytest.mark.parametrize("M", [32, 24], ids=["k5", "dense"])
def test_monitor(runs, M):
    """The single-pass form (K5's plain route) for a power of two M, the
    dense form otherwise; the tone's channel is the strongest."""
    r = runs[f"monitor {M}"]
    assert r["p"].returncode == 0, r["p"].stderr[-2000:]
    assert r["out"].exists() and np.load(r["wf"]).shape[-1] == M
    assert r["p"].stdout.splitlines()[1].split()[1] == "7"


def test_demo(runs):
    p = runs["demo"]
    assert p.returncode == 0, p.stderr[-2000:]
    assert "SSB @ +37 kHz" in p.stdout


def test_cat_serves_until_interrupted():
    proc = subprocess.Popen([sys.executable, "-m", "radioframe_torch.cli", "cat", "--port", "0",
                             "--device", "cpu"], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 120.0)
        assert ready, "the cat command printed nothing in 120 s"
        line = proc.stdout.readline()
        assert line.startswith("CAT server on "), (line, proc.stderr.read() if
                                                   proc.poll() is not None else "")
        port = int(line.split()[3].rsplit(":", 1)[1])
        with socket.create_connection(("127.0.0.1", port), timeout=10.0) as s:
            s.settimeout(10.0)
            s.sendall(b"ID;FA00000039000;FA;")
            got = b""
            while not got.endswith(b"FA00000039000;"):
                got += s.recv(4096)
            assert got == b"ID020;FA00000039000;"
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_scripts_run_on_cpu(runs, script):
    p = runs[script]
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip()


def test_channelizer_demo_writes_a_png(runs):
    """The waterfall PNG is written without a plotting package: a valid
    8-bit grayscale image of the waterfall's lines x channels."""
    import struct
    import zlib

    out = runs["torch_channelizer_demo"].args[-1]
    data = Path(out).read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h, depth, color = struct.unpack(">IIBB", data[16:26])
    assert (w, depth, color) == (32, 8, 0)
    idat = data[data.index(b"IDAT") + 4:data.index(b"IEND") - 8]
    assert len(zlib.decompress(idat)) == h * (w + 1)
