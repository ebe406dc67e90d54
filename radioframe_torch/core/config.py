"""Typed config tree (the port's copy of ``radioframe/core/config.py``,
field for field and default for default; ``tests/test_torch_guards.py``
holds the two equal).

Configs are frozen dataclasses. Runtime-tunable quantities (per-channel
frequency, mode) are not here: they are tensors fed to the step function.
Comments that name Pallas kernels or TPU options describe the reference's
meaning of a field; the port's chains say which options they carry.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class CicStage:
    """CIC decimator stage (FIR-equivalent block semantics)."""

    R: int
    N: int = 4
    M: int = 1


@dataclass(frozen=True)
class FirStage:
    """FIR decimation stage; compensates preceding CIC droop if any."""

    R: int
    numtaps: int = 129
    passband_hz: float = 4000.0
    stopband_hz: float | None = None  # default: 0.45 * fs_out


@dataclass(frozen=True)
class AgcConfig:
    """Attack/release/hang AGC constants (reference `[U:agc.c]` parity).

    Defaults preserve the round-1 behavior: instant attack, no hang."""

    release_s: float = 0.5
    target: float = 0.5
    max_gain: float = 1e4
    attack_s: float = 0.0   # gain-reduction smoothing; 0 = instant attack
    hang_s: float = 0.0     # peak hold time before release starts


# Per-mode AGC profiles, indexed by demod mode code (SSB/CW/AM/NFM/LSB/SAM).
# The reference keeps distinct attack/release/hang constants per mode in its
# settings struct; NFM's entry is present for table shape but bypassed (FM
# audio is deviation-scaled, AGC-free — see pipelines/rx_chain.py).
DEFAULT_AGC_MODES = (
    AgcConfig(release_s=0.5, attack_s=0.002, hang_s=0.02),    # SSB
    AgcConfig(release_s=0.25, attack_s=0.001, hang_s=0.01),   # CW
    AgcConfig(release_s=0.8, attack_s=0.005, hang_s=0.02),    # AM
    AgcConfig(),                                              # NFM (bypassed)
    AgcConfig(release_s=0.5, attack_s=0.002, hang_s=0.02),    # LSB
    AgcConfig(release_s=0.8, attack_s=0.005, hang_s=0.02),    # SAM
)


@dataclass(frozen=True)
class ModeFilters:
    """Per-mode channel filter bandwidths at audio rate (Hz)."""

    ssb_lo: float = 300.0
    ssb_hi: float = 2700.0
    cw_halfwidth: float = 250.0
    am_halfwidth: float = 5000.0
    nfm_halfwidth: float = 8000.0
    # 513 taps + hop 512 -> OLS nfft exactly 1024 (pow2 hop AND pow2 FFT)
    numtaps: int = 513


@dataclass(frozen=True)
class RxConfig:
    """One RX signal chain: fs_in IQ -> decimation stages -> audio."""

    fs_in: float = 192_000.0
    channels: int = 1
    stages: tuple = (CicStage(R=2, N=4), FirStage(R=2))
    mode_filters: ModeFilters = field(default_factory=ModeFilters)
    agc: AgcConfig = field(default_factory=AgcConfig)
    # per-mode AGC constants (len-6 tuple indexed by demod mode code);
    # None -> cfg.agc for every mode. Use DEFAULT_AGC_MODES for the
    # reference-style per-mode profile.
    agc_modes: tuple | None = None
    cw_tone_hz: float = 600.0
    nfm_deviation_hz: float = 2500.0
    ols_hop: int = 512
    # fuse NCO mix + first decimator into one Pallas kernel (saves the
    # full-ADC-rate HBM round trips; see kernels/fused_frontend.py)
    fuse_frontend: bool = False
    # how many decimation stages the fused kernel swallows: 2 additionally
    # fuses the second FIR stage in-VMEM (kernels/fused_frontend2.py) when
    # it is real-tapped with a power-of-two R — the stage-1 output then
    # never round-trips HBM at fs/R1
    fuse_frontend_depth: int = 1
    # int16 ADC ingest: the fused v2 kernel reads raw int16 count planes
    # (the reference ADC's native format, [U:fpga.c] IQ words) and upcasts
    # in VMEM — halves the dominant HBM read traffic. Requires
    # fuse_frontend_depth=2; drive the chain via step_i16/step_front_i16.
    int16_ingest: bool = False
    # transport for the fused front end's full-rate raw-IQ halo under time
    # sharding: "ppermute" (XLA-scheduled) or "rdma" (explicit Pallas
    # make_async_remote_copy, overlapped with the interior compute via the
    # linearity split in FusedFrontend.boundary_correction)
    halo_transport: str = "ppermute"
    spectrum_nfft: int = 1024
    spectrum_avg: float = 0.0
    emit_spectrum: bool = False
    # interference fighters (SURVEY §2.1 #12/#13); static enables — the
    # reference's menu toggles map to config + recompile (cheap, rare)
    nb_enabled: bool = False
    nb_threshold: float = 6.0
    nr_enabled: bool = False
    nr_nfft: int = 256
    notch_enabled: bool = False
    notch_nfft: int = 256
    # streaming VAD (`[U:vad.c]`): per-frame voice flags at nr_nfft; gates
    # SpectralNR's noise-estimate update (speech never learned as noise)
    # and is reported in aux["vad_active"]
    vad_enabled: bool = False
    vad_energy_ratio: float = 3.0
    vad_flatness_max: float = 0.5
    # statically restrict which demods compile (None = all six; see
    # ops/demod.py bank_apply): the reference's mode menu maps to config +
    # cheap recompile, so unused demods cost nothing
    enabled_modes: tuple | None = None
    # FM squelch (gates NFM audio on discriminator HF noise)
    squelch_enabled: bool = False
    # the fused OLS+demod+AGC back-end kernel K6 (kernels/ols_demod.py):
    # RxChain runs it on a CUDA card wherever the configuration admits it
    # (enabled_modes without SAM, hang_s=0, the interference/squelch/
    # deemphasis stages off); True insists on it, on the CPU too, and
    # raises what refuses it
    fuse_backend: bool = False
    # DFT matmul precision for the fused back end: "highest" | "b3"
    # (manual bf16x3 — half the MXU passes, ~2^-21 rel; see pfb_dft)
    backend_dft_precision: str = "highest"
    squelch_threshold: float = 0.5
    # NFM de-emphasis time constant (seconds); 0 disables. 531e-6 is the
    # amateur-NFM standard complement to TX pre-emphasis
    nfm_deemphasis_s: float = 0.0

    @property
    def decim(self) -> int:
        r = 1
        for s in self.stages:
            r *= s.R
        return r

    @property
    def fs_audio(self) -> float:
        return self.fs_in / self.decim


@dataclass(frozen=True)
class TxConfig:
    """DUC transmit chain: audio -> modulator -> interpolation -> fs_out IQ."""

    fs_out: float = 192_000.0
    fs_audio: float = 48_000.0
    channels: int = 1
    # interpolation plan: ints = FIR stages (anti-image, inverse-sinc
    # pre-compensated when a CIC follows); CicStage entries = CIC
    # interpolators for bulk upsampling to DAC rate (SURVEY.md §2.1 #10)
    interp_stages: tuple = (2, 2)
    numtaps_per_stage: int = 65
    mode_filters: ModeFilters = field(default_factory=ModeFilters)
    am_depth: float = 0.9
    nfm_deviation_hz: float = 2500.0
    # speech processor (mic compressor); max_gain=1.0 makes it transparent
    compressor_target: float = 0.7
    compressor_max_gain: float = 4.0
    compressor_release_s: float = 0.05
    # TX mic equalizer: peaking-EQ bands (center_hz, gain_db, Q) applied
    # between the DC block and the compressor (reference TX EQ in
    # `[U:audio_processor.c]`); () disables
    mic_eq_bands: tuple = ()

    @property
    def interp(self) -> int:
        r = 1
        for st in self.interp_stages:
            r *= st.R if isinstance(st, CicStage) else int(st)
        return r


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh axes for sharded runs (SURVEY.md §2.3)."""

    channel: int = 1
    time: int = 1

    @property
    def num_devices(self) -> int:
        return self.channel * self.time
