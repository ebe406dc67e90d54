"""Chain presets (the port's copy of ``radioframe/core/presets.py``):
multi-stage decimation plans with CIC-first ordering, the transmit chain's
DAC-rate interpolation plan, and the config-5 wideband channelizer."""

from __future__ import annotations

from radioframe_torch.core.config import CicStage, FirStage, RxConfig, TxConfig


def capture_192k(channels: int = 1, **kw) -> RxConfig:
    """192 kHz IQ capture -> 48 kHz audio (BASELINE config 1)."""
    return RxConfig(fs_in=192_000.0, channels=channels,
                    stages=(CicStage(R=2, N=4), FirStage(R=2)), **kw)


def wideband_1536k(channels: int = 64, **kw) -> RxConfig:
    """1.536 Msps wideband -> 48 kHz (the 64-channel sharded-DDC shape)."""
    return RxConfig(
        fs_in=1_536_000.0, channels=channels,
        stages=(CicStage(R=8, N=4), FirStage(R=4, numtaps=97, passband_hz=15_000.0)),
        **kw)


def adc_61m44(channels: int = 1, audio_fs: float = 48_000.0, **kw) -> RxConfig:
    """Full ADC-rate DDC: 61.44 Msps -> 48 kHz (R=1280):

        CIC(R=32, N=4)  61.44 M -> 1.92 M
        FIR(R=8)        1.92 M  -> 240 k    (inverse-sinc compensated)
        FIR(R=5)        240 k   -> 48 k     (sharp anti-alias)
    """
    if audio_fs != 48_000.0:
        raise ValueError("adc_61m44 ends at 48 kHz audio")
    return RxConfig(
        fs_in=61_440_000.0, channels=channels,
        stages=(
            CicStage(R=32, N=4),
            FirStage(R=8, numtaps=129, passband_hz=20_000.0),
            FirStage(R=5, numtaps=129, passband_hz=20_000.0, stopband_hz=24_000.0),
        ),
        **kw)


def tx_adc_61m44(channels: int = 1, **kw) -> TxConfig:
    """Full DAC-rate DUC: 48 kHz audio -> 61.44 Msps IQ (L=1280), the
    adjoint of the ``adc_61m44`` RX plan:

        FIR(L=5)           48 k   -> 240 k   (sharp anti-image)
        FIR(L=8)           240 k  -> 1.92 M  (inverse-sinc pre-compensated)
        CIC(L=32, N=4)     1.92 M -> 61.44 M (multiplier-free bulk interp)
    """
    return TxConfig(
        fs_out=61_440_000.0, channels=channels,
        interp_stages=(5, 8, CicStage(R=32, N=4)),
        **kw)


def channelizer_61m44(num_channels: int = 4096, fused: bool = True, **kw):
    """BASELINE config 5: 61.44 Msps wideband -> ``num_channels`` critically
    sampled channels (15 kHz each at 4096) with per-channel demod/AGC and
    the PFB-derived waterfall, as the port's ``ChannelizerConfig``.

    ``fused=True`` (default) selects the single-pass channelizer kernel
    (K5) with the SSB/CW/AM/NFM/LSB static mode subset and 16-frame
    waterfall averaging; ``dft_precision="b3"`` is kept for parity with the
    reference's config, and the port computes its DFT in FP32 either way.
    ``fused=False`` returns the dense formulation (all six demods incl.
    SAM, separate panorama FFT)."""
    from radioframe_torch.pipelines.channelizer import ChannelizerConfig

    base = dict(fs_in=61_440_000.0, num_channels=num_channels)
    if fused:
        base.update(emit_spectrum=True, waterfall_from_pfb=True,
                    waterfall_frame_avg=16, fuse_pfb=True, fuse_demod=True,
                    fuse_single_pass=True, dft_precision="b3",
                    enabled_modes=(0, 1, 2, 3, 4))
    base.update(kw)
    return ChannelizerConfig(**base)
