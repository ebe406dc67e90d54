"""A0 golden reference model — pure numpy/scipy, written for clarity not speed.

Per SURVEY.md §4.2/§4.3: the reference firmware ships no test suite and the
reference mount was empty this round, so this module IS the normative
definition of every DSP op's semantics (textbook-correct CIC, standard
SSB/CW/AM/NFM, instant-attack/exp-release AGC). Every JAX op unit-tests
against this model to near-fp32 tolerance; if the reference source appears
later, only parameters here get recalibrated, not op code.

All golden ops are *streaming*: they take and return explicit state so the
block-splitting property tests (SURVEY.md §4.2 #4) can run on the golden
model itself.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# NCO / complex mixer  (SURVEY.md §2.1 #1)
# ---------------------------------------------------------------------------


def nco_mix(x: np.ndarray, freq_hz: float, fs: float, phase0: float = 0.0):
    """Multiply stream by e^{-j(2π f n/fs + phase0)}; returns (y, phase_end).

    Shifts a signal at +freq_hz down to DC. Phase is carried across blocks
    for continuity (mod 2π).
    """
    n = np.arange(len(x), dtype=np.float64)
    w = 2.0 * np.pi * freq_hz / fs
    y = x * np.exp(-1j * (w * n + phase0))
    phase_end = float((phase0 + w * len(x)) % (2.0 * np.pi))
    return y, phase_end


# ---------------------------------------------------------------------------
# Streaming FIR (+decimation)  (SURVEY.md §2.1 #3/#4)
# ---------------------------------------------------------------------------


def fir_state_init(taps: np.ndarray, dtype=np.complex128):
    """State: (tail of L-1 input samples, in-block index of next output)."""
    return np.zeros(len(taps) - 1, dtype=dtype), 0


def fir_decimate(x: np.ndarray, taps: np.ndarray, R: int, state=None):
    """Causal FIR y_full[n] = sum_k h[k] x[n-k], emit y_full[n] for n % R == 0.

    Streaming: ``state=(tail, next_i)`` where tail is the last L-1 inputs and
    next_i the in-block index of the next decimated output. Returns
    (y, new_state). x[n<0] == 0.
    """
    taps = np.asarray(taps)
    L = len(taps)
    if state is None:
        state = fir_state_init(taps, np.result_type(x.dtype, taps.dtype))
    tail, next_i = state
    xp = np.concatenate([tail, x])
    # valid causal outputs for this block: y_full at block-local n = 0..len(x)-1
    full = np.convolve(xp, taps, mode="full")  # len = len(xp)+L-1
    y_all = full[L - 1 : L - 1 + len(x)]
    out_idx = np.arange(next_i, len(x), R)
    y = y_all[out_idx]
    new_next = next_i if len(x) == 0 else int((next_i - len(x)) % R)
    new_tail = xp[len(xp) - (L - 1) :] if L > 1 else xp[:0]
    return y, (new_tail, new_next)


# ---------------------------------------------------------------------------
# CIC decimator  (SURVEY.md §2.1 #2; papers [P])
# ---------------------------------------------------------------------------


def cic_decimate_integrator_comb(x: np.ndarray, R: int, N: int, M: int = 1):
    """Textbook CIC: N integrators @ fs -> ↓R -> N combs (delay M) @ fs/R.

    Full-stream, zero initial conditions, float64. Used only to cross-check
    that the FIR-equivalent form (the normative block semantics) is the same
    operator. Output unnormalized (DC gain (R*M)**N).
    """
    v = np.asarray(x, dtype=np.complex128)
    for _ in range(N):
        v = np.cumsum(v)
    v = v[::R]
    for _ in range(N):
        d = np.zeros_like(v)
        d[M:] = v[:-M]
        v = v - d
    return v


def cic_decimate(x: np.ndarray, R: int, N: int, M: int = 1, state=None, norm: bool = True):
    """Normative CIC block semantics: FIR-equivalent boxcar^N conv + ↓R.

    Identical operator to ``cic_decimate_integrator_comb`` in exact
    arithmetic (verified in tests), but bounded-state and fp-stable.
    """
    from radioframe_torch.ops.filter_design import cic_equivalent_taps

    taps = cic_equivalent_taps(R, N, M, norm=norm)
    return fir_decimate(x, taps, R, state)


# ---------------------------------------------------------------------------
# Overlap-save FFT filtering — golden = direct convolution (R=1 FIR)
# ---------------------------------------------------------------------------


def ols_filter(x: np.ndarray, taps: np.ndarray, state=None):
    """Golden semantics of the OLS engine is plain streaming convolution."""
    return fir_decimate(x, taps, 1, state)


# ---------------------------------------------------------------------------
# AGC  (SURVEY.md §2.1 #8)
# ---------------------------------------------------------------------------


def agc(
    x: np.ndarray,
    release_decay: float,
    target: float = 1.0,
    max_gain: float = 1e4,
    env0: float = 0.0,
    eps: float = 1e-9,
):
    """Peak AGC: instant attack, exponential release.

      env[n]  = max(|x[n]|, release_decay * env[n-1])
      gain[n] = min(max_gain, target / max(env[n], eps))
      y[n]    = x[n] * gain[n]

    Per-sample loop (the reference's per-sample recursion); the JAX op
    implements the same recurrence as an associative scan over the
    (decay, value) max-plus semiring. Returns (y, env_end, gain).
    """
    mag = np.abs(x)
    env = np.empty(len(x), dtype=np.float64)
    e = env0
    for i in range(len(x)):
        e = max(mag[i], release_decay * e)
        env[i] = e
    gain = np.minimum(max_gain, target / np.maximum(env, eps))
    return x * gain, float(e), gain


def agc_full(
    x: np.ndarray,
    release_decay: float,
    attack_alpha: float = 0.0,
    hang_samples: int = 0,
    target: float = 1.0,
    max_gain: float = 1e4,
    state=None,
    eps: float = 1e-9,
):
    """Full AGC: attack smoothing + hang timer + exponential release.

    Normative semantics of the reference's per-mode AGC (`[U:agc.c]`,
    SURVEY.md §2.1 #8 "attack/release/hang ... per-mode time constants"),
    defined per-sample:

      m[n]     = max(|x[k]|, k in [n - hang_samples, n])   (hang: peaks held)
      env_r[n] = max(m[n], release_decay * env_r[n-1])     (release decay)
      env[n]   = attack_alpha*env[n-1] + (1-attack_alpha)*env_r[n]  (attack)
      gain[n]  = min(max_gain, target / max(env[n], eps))

    The hang-then-release identity: sliding-window max followed by the
    max-decay recurrence equals env_r[n] = max_j |x[j]| * g(n-j) with
    g(a) = 1 for a <= hang_samples, release_decay^(a-hang) after — i.e.
    every peak is held flat for the hang time, then released exponentially.
    attack_alpha = exp(-1/(attack_s*fs)) smooths gain reduction on signal
    rise with the attack time constant (0 = instant attack).

    state = (hist (hang_samples,) recent |x|, env_r, env). Streaming-exact:
    block splits reproduce the full-stream result bit-for-bit.
    Returns (y, new_state, gain).
    """
    mag = np.abs(np.asarray(x)).astype(np.float64)
    W = int(hang_samples)
    if state is None:
        state = (np.zeros(W, dtype=np.float64), 0.0, 0.0)
    hist, er, es = state
    assert len(hist) == W
    xp = np.concatenate([hist, mag])
    env = np.empty(len(mag), dtype=np.float64)
    for i in range(len(mag)):
        m = xp[i : i + W + 1].max()  # window of W+1 samples ending at i
        er = max(m, release_decay * er)
        es = attack_alpha * es + (1.0 - attack_alpha) * er
        env[i] = es
    gain = np.minimum(max_gain, target / np.maximum(env, eps))
    new_hist = xp[len(xp) - W :] if W else xp[:0]
    return x * gain, (new_hist, float(er), float(es)), gain


# ---------------------------------------------------------------------------
# DC blocker (one-pole high-pass)  (SURVEY.md §2.1 #13)
# ---------------------------------------------------------------------------


def dc_block(x: np.ndarray, pole: float = 0.995, state=None):
    """y[n] = x[n] - x[n-1] + pole*y[n-1]; state = (x_prev, y_prev)."""
    if state is None:
        state = (0.0, 0.0)
    xp, yp = state
    y = np.empty_like(np.asarray(x, dtype=np.float64))
    for i in range(len(x)):
        y[i] = x[i] - xp + pole * yp
        xp, yp = x[i], y[i]
    return y, (float(xp), float(yp))


# ---------------------------------------------------------------------------
# Demodulators  (SURVEY.md §2.1 #9)
# ---------------------------------------------------------------------------


def demod_ssb(x: np.ndarray):
    """After a one-sided complex BPF, SSB audio is 2*Re{x}."""
    return 2.0 * np.real(x)


def demod_cw(x: np.ndarray, tone_hz: float, fs: float, phase0: float = 0.0):
    """CW: shift carrier (at DC after tuning) to an audible beat tone."""
    n = np.arange(len(x), dtype=np.float64)
    w = 2.0 * np.pi * tone_hz / fs
    y = 2.0 * np.real(x * np.exp(1j * (w * n + phase0)))
    return y, float((phase0 + w * len(x)) % (2.0 * np.pi))


def demod_am(x: np.ndarray, dc_state=None):
    """AM envelope detector: |x| then DC block to strip the carrier level."""
    env = np.abs(x)
    return dc_block(env, 0.995, dc_state)


def demod_sam(x: np.ndarray, fs: float, dc_state=None, phase0: float = 0.0):
    """Synchronous AM, block-wise carrier recovery (mirrors ops.demod.demod_sam).

    Residual carrier = angle of the lag-1 autocorrelation; derotate with
    carried phase, align the mean phasor, Re{}, DC block.
    Returns (audio, dc_state, (phase_end, w)).
    """
    x = np.asarray(x, dtype=np.complex128)
    r1 = np.sum(x[1:] * np.conj(x[:-1]))
    w = float(np.angle(r1))
    n = np.arange(len(x), dtype=np.float64)
    derot = x * np.exp(-1j * (phase0 + w * n))
    mean = derot.sum()
    mean = mean / max(abs(mean), 1e-9)
    coherent = np.real(derot * np.conj(mean))
    audio, dc_state = dc_block(coherent, 0.995, dc_state)
    phase_end = float((phase0 + w * len(x)) % (2.0 * np.pi))
    return audio, dc_state, (phase_end, w)


def squelch(audio: np.ndarray, noise_state: float = 0.0, threshold: float = 0.5,
            pole: float = 0.5):
    """FM squelch (mirrors ops.demod.squelch): per-block one-pole on the
    mean |diff| discriminator-noise metric; gate when above threshold."""
    hf = float(np.mean(np.abs(np.diff(audio))))
    smoothed = pole * noise_state + (1.0 - pole) * hf
    is_open = smoothed < threshold
    return audio * is_open, smoothed, is_open


def demod_nfm(x: np.ndarray, fs: float, deviation_hz: float, last=None):
    """NFM: phase-differentiate, scale so ±deviation maps to ±1.

      y[n] = angle(x[n] * conj(x[n-1])) * fs / (2π * deviation)

    state = previous complex sample (x[-1]; 1+0j at stream start).
    """
    if last is None:
        last = np.complex128(1.0)
    xprev = np.concatenate([[last], x[:-1]])
    dphi = np.angle(x * np.conj(xprev))
    y = dphi * fs / (2.0 * np.pi * deviation_hz)
    new_last = x[-1] if len(x) else last
    return y, np.complex128(new_last)


# ---------------------------------------------------------------------------
# Modulators + DUC  (SURVEY.md §2.1 #10)
# ---------------------------------------------------------------------------


def mod_ssb(audio: np.ndarray, bpf_taps: np.ndarray, state=None):
    """SSB (filter-method) modulator: one-sided complex BPF of real audio."""
    return ols_filter(audio.astype(np.complex128), bpf_taps, state)


def mod_am(audio: np.ndarray, depth: float = 0.9):
    return (1.0 + depth * audio).astype(np.complex128)


def mod_fm(audio: np.ndarray, fs: float, deviation_hz: float, phase0: float = 0.0):
    """FM: integrate scaled audio into phase; state = accumulated phase."""
    if len(audio) == 0:
        return np.zeros(0, np.complex128), phase0
    w = 2.0 * np.pi * deviation_hz / fs
    phase = phase0 + w * np.cumsum(audio)
    y = np.exp(1j * phase)
    return y, float(phase[-1] % (2.0 * np.pi))


def interpolate(x: np.ndarray, L: int, taps: np.ndarray, state=None):
    """Zero-stuff by L then anti-image FIR (taps include gain L)."""
    up = np.zeros(len(x) * L, dtype=np.complex128)
    up[::L] = x
    return fir_decimate(up, taps, 1, state)


# ---------------------------------------------------------------------------
# Spectrum / waterfall  (SURVEY.md §2.1 #11)
# ---------------------------------------------------------------------------


def spectrum(x: np.ndarray, nfft: int, window: np.ndarray | None = None, avg: float = 0.0, prev=None):
    """Panorama FFT: windowed FFT magnitude (dB), fftshifted, EMA-averaged."""
    if window is None:
        window = np.hanning(nfft)
    frames = len(x) // nfft
    xs = x[: frames * nfft].reshape(frames, nfft) * window
    mag = np.abs(np.fft.fftshift(np.fft.fft(xs, axis=-1), axes=-1))
    db = 20.0 * np.log10(np.maximum(mag, 1e-12))
    if avg > 0.0:
        out = np.empty_like(db)
        p = db[0] if prev is None else prev
        for i in range(frames):
            p = avg * p + (1.0 - avg) * db[i]
            out[i] = p
        return out, p
    return db, (db[-1] if frames else prev)


# ---------------------------------------------------------------------------
# PFB channelizer  (SURVEY.md §7 P6 / config 5)
# ---------------------------------------------------------------------------


def pfb_channelize(x: np.ndarray, M: int, proto_taps: np.ndarray):
    """Critically-sampled M-channel polyphase filterbank (full-stream golden).

    Channel c output rate fs/M, centered at +c*fs/M:
      y[m, c] = sum_p  (x_p * h_p)[m] · e^{-j2π p c / M}   (DFT across phases)
    where x_p[m] = x[mM + p] and h_p the type-1 polyphase components. (With
    type-1 phases a DFT — not IDFT — aligns channel c with +c*fs/M: a tone at
    ω=2πc/M gives x_p ∝ e^{+j2πcp/M}, and the DFT bin c collects it.)
    """
    T = len(proto_taps) // M
    h = np.asarray(proto_taps, dtype=np.float64)[: T * M].reshape(T, M)
    frames = len(x) // M
    xf = np.asarray(x)[: frames * M].reshape(frames, M)
    # polyphase filter each phase p: u[m, p] = sum_t h[t, p] * xf[m - t, p]
    u = np.zeros((frames, M), dtype=np.complex128)
    for t in range(T):
        shifted = np.zeros_like(xf)
        shifted[t:] = xf[: frames - t]
        u += h[t][None, :] * shifted
    y = np.fft.fft(u, axis=-1)  # DFT across phases
    return y


# ---------------------------------------------------------------------------
# Interference fighters  (SURVEY.md §2.1 #12/#13: [U:noise_reduction.c],
# [U:noise_blanker.c], [U:auto_notch.c], [U:vad.c]) — the A0 contract for
# radioframe/ops/interference.py, written per-frame/per-sample for clarity.
# ---------------------------------------------------------------------------


def spectral_nr(x, nfft=256, beta=1.5, floor=0.1, bias=1.0, up=1.1,
                noise_est=None, voice=None):
    """FFT-domain spectral subtraction, one block (single channel).

    Minimum-statistics noise estimate: per-bin min over the block's frames
    (voice-flagged frames excluded when ``voice`` given), followed down
    instantly and up by at most ``up`` per block; the min of F Rayleigh
    magnitudes is rescaled by bias*sqrt(F) toward the mean. Returns
    (y (T,), new noise_est (nfft,)).
    """
    x = np.asarray(x)
    F = len(x) // nfft
    X = np.fft.fft(x[: F * nfft].reshape(F, nfft), axis=-1)
    mag = np.abs(X)
    if noise_est is None:
        noise_est = np.full(nfft, 1e3)
    if voice is None:
        quiet = np.ones(F, bool)
    else:
        quiet = ~np.asarray(voice, bool)
    if quiet.any():
        block_min = mag[quiet].min(axis=0)
        est = np.minimum(noise_est * up, block_min * (bias * np.sqrt(F)))
    else:
        est = noise_est  # every frame voice-active: estimate frozen
    gain = np.clip(1.0 - beta * est[None, :] / np.maximum(mag, 1e-9), floor, 1.0)
    y = np.fft.ifft(X * gain, axis=-1).reshape(F * nfft)
    return y.astype(x.dtype), est


def noise_blanker(x, threshold=6.0, avg_pole=0.999, power_est=0.0):
    """Impulse blanker, per-sample (single channel): a one-pole running mean
    of |x|^2 tracks the background; samples above threshold^2 * mean are
    zeroed. Returns (y, final power_est)."""
    x = np.asarray(x)
    y = x.copy()
    k2 = float(threshold) ** 2
    avg = float(power_est)
    for n in range(len(x)):
        p = abs(x[n]) ** 2
        avg = avg_pole * avg + (1.0 - avg_pole) * p
        if p > k2 * max(avg, 1e-12):
            y[n] = 0.0
    return y, np.float32(avg)


def auto_notch(x, nfft=256, ema=0.9, ratio=8.0, neighborhood=3, mag_ema=None):
    """Spectral auto-notch, one block (single channel): per-bin EMA of the
    block-mean magnitude; bins whose EMA exceeds ``ratio``x the mean of the
    ±neighborhood surrounding bins (a LOCAL peak — a carrier) are nulled.
    Returns (y (T,), new mag_ema (nfft,))."""
    x = np.asarray(x)
    F = len(x) // nfft
    X = np.fft.fft(x[: F * nfft].reshape(F, nfft), axis=-1)
    mag = np.abs(X)
    if mag_ema is None:
        mag_ema = np.zeros(nfft)
    new_ema = ema * mag_ema + (1.0 - ema) * mag.mean(axis=0)
    W = int(neighborhood)
    bg = sum(np.roll(new_ema, s) for s in range(-W, W + 1) if s != 0) / (2 * W)
    notch = new_ema > ratio * np.maximum(bg, 1e-9)
    y = np.fft.ifft(X * np.where(notch[None, :], 0.0, 1.0), axis=-1).reshape(F * nfft)
    return y.astype(x.dtype), new_ema


def vad_stream(x, nfft=256, energy_ratio=3.0, flatness_max=0.5, up=1.1,
               floor=None):
    """Streaming VAD, one block (single channel): per-frame mean power and
    spectral flatness (geometric/arithmetic mean ratio); the quiet floor is
    minimum-statistics tracked (down instantly via the block-min frame
    energy, up by ``up`` per block). A frame is voice when energy >
    ratio*floor AND flatness < flatness_max. Returns (flags (F,), floor)."""
    x = np.asarray(x)
    F = len(x) // nfft
    X = np.fft.fft(x[: F * nfft].reshape(F, nfft), axis=-1)
    p = np.abs(X) ** 2 + 1e-12
    energy = p.mean(axis=-1)
    if floor is None:
        floor = 1e6
    floor = min(floor * up, energy.min())
    flat = np.exp(np.log(p).mean(axis=-1)) / energy
    return (energy > energy_ratio * floor) & (flat < flatness_max), floor
