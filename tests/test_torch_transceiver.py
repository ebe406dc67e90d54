"""The control plane of the port: api/bands.py, api/transceiver.py (the
VFO, split, RIT/XIT and PTT routing over DuplexChain, the S-meter),
api/cat.py and api/cat_tcp.py, against the JAX package's Transceiver and
CatServer, ported from tests/test_transceiver.py, test_cat.py and
test_cat_tcp.py.

Tolerances: RX audio 1e-3 (the whole-chain bound) after block 0, the NFM
channel modulo fs/deviation = 19.2 (an atan2 branch flip); TX IQ 5e-4
(tests/test_sharded_tx.py's bound); muted halves exactly zero; CAT
responses string-equal to the JAX CatServer's."""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from radioframe.api.cat import CatServer as JCatServer
from radioframe.api.transceiver import Transceiver as JTransceiver
from radioframe.core import config as jcfg
from radioframe_torch.api.bands import BAND_PLAN, BandMemory, band, band_of
from radioframe_torch.api.cat import CatServer
from radioframe_torch.api.cat_tcp import CatTcpServer
from radioframe_torch.api.transceiver import Transceiver, s_meter
from radioframe_torch.core.config import RxConfig, TxConfig
from radioframe_torch.core.stream import CaptureSource
from radioframe_torch.io import fixtures as FX

torch.set_num_threads(2)

C = 2
NFM_PERIOD = 19.2


def _trx(channels=C):
    return Transceiver(RxConfig(channels=channels), TxConfig(channels=channels), device="cpu")


@pytest.fixture(scope="module")
def jtrx():
    return JTransceiver(jcfg.RxConfig(channels=C), jcfg.TxConfig(channels=C))


# --- bands, VFOs, S-meter --------------------------------------------------------------------


def test_band_plan_sane():
    for b in BAND_PLAN:
        assert b.lo_hz < b.default_hz < b.hi_hz
    assert band("40m").lo_hz == 7_000_000.0
    assert band_of(14_200_000.0).name == "20m"
    assert band_of(13_000_000.0) is None


def test_band_memory_roundtrip():
    m = BandMemory()
    assert m.recall("20m") == (14_200_000.0, "ssb")  # the plan's default
    m.store(14_075_000.0, "cw")
    assert m.recall("20m") == (14_075_000.0, "cw")
    assert BandMemory.from_dict(m.to_dict()).recall("20m") == (14_075_000.0, "cw")


def test_vfo_split_rit_xit():
    t = _trx()
    t.tune(0, 7_100_000.0)
    t.vfo_b(0, 7_150_000.0)
    assert t.rx_frequency(0) == 7_100_000.0
    assert t.tx_frequency(0) == 7_100_000.0  # no split: TX on VFO A
    t.split(0, True)
    assert t.tx_frequency(0) == 7_150_000.0
    t.rit(0, -200.0)
    t.xit(0, 50.0)
    assert t.rx_frequency(0) == 7_099_800.0
    assert t.tx_frequency(0) == 7_150_050.0
    t.split(0, False)
    t.swap_vfo(0)
    assert t.rx_frequency(0) == 7_150_000.0 - 200.0


def test_step_words_match_reference_routing(jtrx):
    """The words and modes a block is stepped with: VFO B on receive, split,
    RIT/XIT, and SAM sent as AM, as the JAX Transceiver computes them."""
    from radioframe.ops import nco as jnco

    t = _trx()
    t.tune(0, 37_000.0)
    t.tune(1, -15_000.0)
    t.vfo_b(0, 20_000.0)
    t.vfo_b(1, 12_000.0)
    t.select_rx_vfo(0, 1)
    t.split(1, True)
    t.rit(0, -200.0)
    t.xit(1, 50.0)
    t.set_mode(0, "sam")
    t.set_mode(1, "nfm")
    rx_w, rx_m, tx_w, tx_m = t.step_inputs()
    assert np.array_equal(rx_w, jnco.freq_word(np.array([19_800.0, -15_000.0]), 192_000.0))
    assert np.array_equal(tx_w, jnco.freq_word(np.array([37_000.0, 12_050.0]), 192_000.0))
    assert rx_m.tolist() == [5, 3] and tx_m.tolist() == [2, 3]


def test_band_switch_recalls_memory():
    t = _trx()
    t.set_band(0, "40m")
    assert t.rx_frequency(0) == band("40m").default_hz and t.mode(0) == "lsb"
    t.tune(0, 7_030_000.0)
    t.set_mode(0, "cw")
    t.set_band(0, "20m")  # stores the 40m spot on the way out
    assert t.mode(0) == "ssb"
    t.set_band(0, "40m")
    assert t.rx_frequency(0) == 7_030_000.0 and t.mode(0) == "cw"


def test_s_meter_calibration():
    assert s_meter(10 ** (-73 / 10.0)) == "S9"  # IARU S9 = -73 dBm
    assert s_meter(10 ** (-93 / 10.0)) == "S6"  # 6 dB per S-unit
    assert s_meter(10 ** (-53 / 10.0)) == "S9+20"
    assert s_meter(0.0) == "S0"


def test_mismatched_channels_and_device_refused():
    with pytest.raises(ValueError, match="channels"):
        Transceiver(RxConfig(channels=2), TxConfig(channels=1), device="cpu")
    with pytest.raises(TypeError):
        Transceiver(RxConfig(channels=2), TxConfig(channels=2))  # no default device


# --- the data plane against the JAX Transceiver --------------------------------------------


def _setup(t):
    for trx in t:
        trx.tune(0, 37_000.0)
        trx.tune(1, -15_000.0)
        trx.vfo_b(1, -14_000.0)
        trx.split(1, True)
        trx.rit(0, -100.0)
        trx.xit(1, 50.0)
        trx.set_mode(0, "ssb")
        trx.set_mode(1, "nfm")


def test_ptt_routing_matches_reference(jtrx):
    """Three blocks: PTT up twice (RX audio live, TX IQ zero), then PTT down
    with channel 1 in SAM (RX muted, TX IQ live, SAM sent as AM)."""
    t = _trx()
    _setup((t, jtrx))
    T = 4 * t.chain.rx.min_block
    Ta = T // t.rx_cfg.decim
    n = 3 * T
    iq = (FX.ssb_capture(192_000.0, n, 37_100.0)[0]
          + FX.nfm_capture(192_000.0, n, -15_000.0)[0]).astype(np.complex64)
    mic = np.stack([FX.voicelike_audio(48_000.0, 3 * Ta, seed=s) for s in (1, 2)])
    for blk in range(3):
        keyed = blk == 2
        for trx in (t, jtrx):
            trx.ptt(keyed)
            trx.set_mode(1, "sam" if keyed else "nfm")
        x = np.broadcast_to(iq[blk * T:(blk + 1) * T], (C, T))
        a = mic[:, blk * Ta:(blk + 1) * Ta].astype(np.float32)
        audio, tx_iq = t.process(x, a)
        j_audio, j_tx = jtrx.process(x, a)
        assert audio.shape == j_audio.shape == (C, Ta) and tx_iq.shape == j_tx.shape
        if keyed:
            assert not audio.any() and not j_audio.any()
            assert np.abs(tx_iq).max() > 0.1
            np.testing.assert_allclose(tx_iq, j_tx, atol=5e-4)
        else:
            assert not tx_iq.any() and not j_tx.any()
            if blk > 0:  # block 0: the cold-start AGC transient
                d = audio - j_audio
                d[1] -= NFM_PERIOD * np.round(d[1] / NFM_PERIOD)
                np.testing.assert_allclose(d, 0.0, atol=1e-3)
            assert np.abs(audio).max() > 0.1
        assert t.s_meter(0) == jtrx.s_meter(0) and t.s_meter(0).startswith("S")
        assert CatServer(t).handle("SM0;") == JCatServer(jtrx).handle("SM0;")


# --- CAT: the command script of tests/test_cat.py, against the JAX CatServer ------------------

CAT_SCRIPT = [
    "FA00007100000;", "FA;", "FB00007105000;", "FB;", "FA00014200000;FA;MD2;MD;",
    "MD1;", "MD;", "MD2;", "MD;", "MD3;", "MD;", "MD4;", "MD;", "MD5;", "MD;", "MD9;",
    "FA00007100000;FB00007200000;", "FR1;", "FR1;", "FR;", "IF;", "FR0;", "FR;", "IF;",
    "FA00014074000;MD2;FT1;", "IF;", "FT;", "FT0;", "FT;", "ZZ;", "FAxx;", "FB12a4;", "KSqq;",
    "AI?;", "ID;", "TX;", "IF;", "RX;", "IF;", "PS;", "KS099;", "KS;", "KS002;", "KS;",
    "AI1;", "AI;", "SM0;", "fa;", " FA ; ;", "FR2;", "MD;FA00003500000;MD1;IF;",
]


def _reset(trx):
    trx._vfo_a[:] = 0.0
    trx._vfo_b[:] = 0.0
    trx._rit[:] = 0.0
    trx._xit[:] = 0.0
    trx._split[:] = False
    trx._rx_vfo[:] = 0
    trx._modes[:] = 0
    trx.ptt(False)
    trx.last_aux = None


@pytest.mark.parametrize("channel", [0, 1])
def test_cat_script_responses_equal_reference(jtrx, channel):
    t = _trx()
    _reset(t)
    _reset(jtrx)
    cat, jcat = CatServer(t, channel=channel), JCatServer(jtrx, channel=channel)
    for cmd in CAT_SCRIPT:
        assert cat.handle(cmd) == jcat.handle(cmd), cmd
        assert t.transmitting == jtrx.transmitting
        assert t.rx_frequency(channel) == jtrx.rx_frequency(channel)


def test_cat_if_frame_layout():
    cat = CatServer(_trx())
    cat.handle("FA00014074000;MD2;FT1;FR1;")
    frame = cat.handle("IF;")
    assert len(frame[2:-1]) == 35  # the TS-480 content length after 'IF'
    assert frame[29] == "2" and frame[30] == "1" and frame[32] == "1"  # P9, P10, P12


# --- CAT over TCP (tests/test_cat_tcp.py) -------------------------------------------------------


def _client(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    s.settimeout(5.0)
    return s


def _ask(sock, cmd: str) -> str:
    sock.sendall(cmd.encode())
    return sock.recv(4096).decode()


@pytest.fixture
def srv():
    with CatTcpServer(CatServer(_trx())) as srv:
        yield srv


def test_tcp_roundtrip(srv):
    with _client(srv.port) as s:
        assert _ask(s, "FA00007100000;FA;") == "FA00007100000;"


def test_tcp_partial_frames_across_packets(srv):
    with _client(srv.port) as s:
        s.sendall(b"FA000071")  # a frame split across packets must not dispatch early
        time.sleep(0.05)
        s.sendall(b"00000;FA;")
        assert s.recv(4096) == b"FA00007100000;"


def test_tcp_unknown_command(srv):
    with _client(srv.port) as s:
        assert _ask(s, "ZZ;") == "?;"


def test_tcp_two_clients(srv):
    with _client(srv.port) as a, _client(srv.port) as b:
        _ask(a, "FA00014200000;FA;")
        assert _ask(b, "FA;") == "FA00014200000;"


def test_tcp_stop_joins_threads():
    server = CatTcpServer(CatServer(_trx()))
    _host, port = server.start()
    with _client(port) as s:
        assert _ask(s, "ID;") == "ID020;"
    server.stop()
    assert not server._threads
    with pytest.raises(OSError):
        _client(port).close()


def test_cat_drives_running_stream():
    """A tone at +40 kHz; the stream starts detuned (quiet), a CAT client
    retunes mid-stream (audio appears), keys PTT (audio muted), unkeys
    (audio returns), with a CaptureSource feeding the duplex stream."""
    trx = _trx(1)
    B = trx.chain.rx.min_block
    fs, tone_hz = trx.rx_cfg.fs_in, 40_000.0
    stop = threading.Event()

    def producer():
        n = 0
        while not stop.is_set():
            t = (np.arange(B) + n * B) / fs
            iq = 8000.0 * np.exp(2j * np.pi * tone_hz * t)
            buf = np.empty(2 * B, np.int16)
            buf[0::2] = np.round(iq.real).astype(np.int16)
            buf[1::2] = np.round(iq.imag).astype(np.int16)
            n += 1
            yield buf

    src = CaptureSource(producer(), block_len=B, channels=1)
    mic = np.zeros(B // trx.rx_cfg.decim, np.float32)
    log, stream_err = [], []

    def stream_loop():
        try:
            for blk in src:
                with srv.lock:
                    audio, _tx = trx.process(blk, mic)
                log.append(float(np.sqrt(np.mean(audio[0] ** 2))))
                if stop.is_set():
                    return
        except Exception as e:  # surfaced below
            stream_err.append(e)

    def wait_blocks(n, timeout=60.0):
        t0 = time.monotonic()
        while len(log) < n:
            assert not stream_err, stream_err
            assert time.monotonic() - t0 < timeout, f"stream stalled at {len(log)}"
            time.sleep(0.01)

    def wait_ptt(value, timeout=10.0):
        t0 = time.monotonic()
        while trx.transmitting is not value:  # TX;/RX; answer nothing: wait for the flip
            assert time.monotonic() - t0 < timeout, "PTT command lost"
            time.sleep(0.005)

    with CatTcpServer(CatServer(trx, channel=0)) as srv:
        th = threading.Thread(target=stream_loop, daemon=True)
        th.start()
        cli = _client(srv.port)
        try:
            wait_blocks(4)
            n1 = len(log)
            _ask(cli, "FA00000039000;MD2;FA;")  # the tone lands at +1 kHz, in the passband
            sent_tune = len(log)
            wait_blocks(sent_tune + 6)
            cli.sendall(b"TX;")
            wait_ptt(True)
            sent_tx = len(log)
            wait_blocks(sent_tx + 6)
            cli.sendall(b"RX;")
            wait_ptt(False)
            sent_rx = len(log)
            wait_blocks(sent_rx + 6)
        finally:
            stop.set()
            cli.close()
        th.join(timeout=30.0)
    assert not th.is_alive() and not stream_err, stream_err
    rms = np.asarray(log)
    assert rms[1:n1].max() < 0.05, rms[1:n1]  # detuned: quiet (block 0: OLS warm-up)
    assert rms[sent_tune + 1: sent_tx].max() > 0.1  # retuned: audio
    assert rms[sent_tx + 1: sent_rx].min() == 0.0  # keyed: RX hard-muted
    assert rms[sent_rx + 1:].max() > 0.1  # unkeyed: audio returns
