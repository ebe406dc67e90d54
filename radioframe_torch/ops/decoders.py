"""CW (Morse) and RTTY (Baudot FSK) decoders (SURVEY.md §2.1 #14).

Reference analogs: `[U:cw_decoder.c]` (Goertzel tone detect + adaptive
dit/dah classification) and `[U:rtty_decoder.c]` (FSK demod + Baudot).
Per SURVEY, the per-symbol state machines run host-side (numpy) on
demodulated audio blocks — they are control-rate, not sample-rate, work;
the tone energy extraction underneath is vectorized.

Encoders are included for loopback testing (the same role the reference's
CW keyer and RTTY TX play).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Morse
# ---------------------------------------------------------------------------

MORSE = {
    "A": ".-", "B": "-...", "C": "-.-.", "D": "-..", "E": ".", "F": "..-.",
    "G": "--.", "H": "....", "I": "..", "J": ".---", "K": "-.-", "L": ".-..",
    "M": "--", "N": "-.", "O": "---", "P": ".--.", "Q": "--.-", "R": ".-.",
    "S": "...", "T": "-", "U": "..-", "V": "...-", "W": ".--", "X": "-..-",
    "Y": "-.--", "Z": "--..", "0": "-----", "1": ".----", "2": "..---",
    "3": "...--", "4": "....-", "5": ".....", "6": "-....", "7": "--...",
    "8": "---..", "9": "----.", "/": "-..-.", "?": "..--..", "=": "-...-",
}
MORSE_INV = {v: k for k, v in MORSE.items()}


def cw_encode_envelope(text: str, fs: float, wpm: float = 20.0) -> np.ndarray:
    """Text -> on/off keying envelope at fs (dit = 1.2/wpm seconds)."""
    dit = int(round(fs * 1.2 / wpm))
    out = []
    for word in text.upper().split():
        for ch in word:
            for sym in MORSE.get(ch, ""):
                out += [1.0] * (dit if sym == "." else 3 * dit)
                out += [0.0] * dit  # intra-character gap
            out += [0.0] * (2 * dit)  # character gap (total 3)
        out += [0.0] * (4 * dit)  # word gap (total 7)
    return np.asarray(out, dtype=np.float64)


def tone_envelope(audio: np.ndarray, fs: float, tone_hz: float, bw_hz: float = 100.0):
    """Magnitude of the audio content near tone_hz (complex mix + lowpass)."""
    n = np.arange(len(audio))
    baseband = audio * np.exp(-2j * np.pi * tone_hz / fs * n)
    # one-pole lowpass ~bw_hz, applied twice for steeper skirt
    a = float(np.exp(-2.0 * np.pi * bw_hz / fs))
    from scipy.signal import lfilter

    env = baseband
    for _ in range(2):
        env = lfilter([1 - a], [1, -a], env)
    return np.abs(env)


def cw_decode(audio: np.ndarray, fs: float, tone_hz: float = 600.0, wpm_hint: float | None = None):
    """Demodulated CW audio -> text. Adaptive threshold + dit/dah clustering."""
    env = tone_envelope(audio, fs, tone_hz)
    lo, hi = np.percentile(env, 10), np.percentile(env, 90)
    if hi < 5 * lo + 1e-12:
        return ""  # no keying present
    key = env > 0.5 * (lo + hi)
    # run-length encode
    edges = np.flatnonzero(np.diff(key.astype(np.int8)))
    runs = np.diff(np.concatenate([[0], edges + 1, [len(key)]]))
    states = key[np.concatenate([[0], edges + 1])]
    marks = runs[states]
    if len(marks) < 2:
        return ""
    if wpm_hint is None:
        # marks are bimodal {1, 3} dits; anchor on the shortest mark so a
        # dah-heavy text doesn't pull the estimate to 3 dits
        dit = np.median(marks[marks <= 1.8 * marks.min()])
    else:
        dit = fs * 1.2 / wpm_hint
    text, sym = [], ""
    for run, on in zip(runs, states):
        units = run / dit
        if on:
            sym += "." if units < 2.0 else "-"
        else:
            if units >= 5.0:  # word gap
                if sym:
                    text.append(MORSE_INV.get(sym, "#"))
                    sym = ""
                text.append(" ")
            elif units >= 2.0:  # char gap
                if sym:
                    text.append(MORSE_INV.get(sym, "#"))
                    sym = ""
    if sym:
        text.append(MORSE_INV.get(sym, "#"))
    return "".join(text).strip()


# ---------------------------------------------------------------------------
# RTTY (Baudot, 45.45 Bd, 170 Hz shift, mark/space tones)
# ---------------------------------------------------------------------------

BAUDOT_LTRS = {
    0b00011: "A", 0b11001: "B", 0b01110: "C", 0b01001: "D", 0b00001: "E",
    0b01101: "F", 0b11010: "G", 0b10100: "H", 0b00110: "I", 0b01011: "J",
    0b01111: "K", 0b10010: "L", 0b11100: "M", 0b01100: "N", 0b11000: "O",
    0b10110: "P", 0b10111: "Q", 0b01010: "R", 0b00101: "S", 0b10000: "T",
    0b00111: "U", 0b11110: "V", 0b10011: "W", 0b11101: "X", 0b10101: "Y",
    0b10001: "Z", 0b00100: " ", 0b00010: "\n", 0b01000: "\r",
}
BAUDOT_INV = {v: k for k, v in BAUDOT_LTRS.items()}


def rtty_encode(text: str, fs: float, baud: float = 45.45,
                mark_hz: float = 2125.0, shift_hz: float = 170.0) -> np.ndarray:
    """Text -> real FSK audio (1.5 stop bits, LSB-first, letters only)."""
    space_hz = mark_hz - shift_hz
    spb = fs / baud
    bits = []
    for ch in text.upper():
        code = BAUDOT_INV.get(ch)
        if code is None:
            continue
        bits += [0]  # start (space)
        bits += [(code >> i) & 1 for i in range(5)]  # LSB first
        bits += [1, 1]  # 2 stop bits (>= 1.5)
    # idle mark before/after
    bits = [1] * 8 + bits + [1] * 8
    n_total = int(round(len(bits) * spb))
    t_idx = (np.arange(n_total) / spb).astype(np.int64).clip(max=len(bits) - 1)
    freq = np.where(np.asarray(bits, dtype=np.int8)[t_idx] == 1, mark_hz, space_hz)
    phase = 2.0 * np.pi * np.cumsum(freq) / fs
    return np.sin(phase)


def rtty_decode(audio: np.ndarray, fs: float, baud: float = 45.45,
                mark_hz: float = 2125.0, shift_hz: float = 170.0) -> str:
    """FSK audio -> text. Mark/space tone envelopes + UART-style framing."""
    space_hz = mark_hz - shift_hz
    bw = baud * 0.75
    m = tone_envelope(audio, fs, mark_hz, bw)
    s = tone_envelope(audio, fs, space_hz, bw)
    bit = (m > s).astype(np.int8)  # 1 = mark
    spb = fs / baud
    text, i = [], 0
    n = len(bit)
    while i < n - int(7 * spb):
        if bit[i] == 1:
            i += 1
            continue
        # candidate start bit: sample mid-bit positions
        centers = (i + spb * (np.arange(7) + 0.5)).astype(np.int64)
        if centers[-1] >= n:
            break
        samples = bit[centers]
        if samples[0] != 0 or samples[6] != 1:  # framing check
            i += 1
            continue
        code = int(sum(int(samples[1 + k]) << k for k in range(5)))
        text.append(BAUDOT_LTRS.get(code, "#"))
        i = int(i + 6.5 * spb)
    return "".join(text).replace("\r", "").replace("\n", "").strip()
