"""Band plan + per-band memories — the `[U:bands.c]` analog (SURVEY.md §2.2).

The reference keeps a table of amateur bands with segment boundaries and a
per-band memory of the last frequency/mode, so band-switching restores where
you left off. Here the table is plain data (IARU region-1-style HF/6m plan,
the reference's market) and the memory is a small host-side dict that rides
along in checkpoints.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Band:
    name: str
    lo_hz: float
    hi_hz: float
    default_hz: float
    default_mode: str  # canonical demod-mode name (see api.radio.MODE_BY_NAME)


# IARU region-1-flavored HF + 6m plan; CW below the phone segment, LSB below
# 10 MHz and USB above (standard operating convention the reference encodes).
BAND_PLAN: tuple[Band, ...] = (
    Band("160m", 1_810_000.0, 2_000_000.0, 1_900_000.0, "lsb"),
    Band("80m", 3_500_000.0, 3_800_000.0, 3_650_000.0, "lsb"),
    Band("60m", 5_351_500.0, 5_366_500.0, 5_357_000.0, "ssb"),
    Band("40m", 7_000_000.0, 7_200_000.0, 7_100_000.0, "lsb"),
    Band("30m", 10_100_000.0, 10_150_000.0, 10_120_000.0, "cw"),
    Band("20m", 14_000_000.0, 14_350_000.0, 14_200_000.0, "ssb"),
    Band("17m", 18_068_000.0, 18_168_000.0, 18_120_000.0, "ssb"),
    Band("15m", 21_000_000.0, 21_450_000.0, 21_250_000.0, "ssb"),
    Band("12m", 24_890_000.0, 24_990_000.0, 24_940_000.0, "ssb"),
    Band("10m", 28_000_000.0, 29_700_000.0, 28_500_000.0, "ssb"),
    Band("6m", 50_000_000.0, 52_000_000.0, 50_150_000.0, "ssb"),
)

_BY_NAME = {b.name: b for b in BAND_PLAN}


def band(name: str) -> Band:
    return _BY_NAME[name.lower()]


def band_of(freq_hz: float) -> Band | None:
    """The band containing freq_hz, or None (general coverage)."""
    for b in BAND_PLAN:
        if b.lo_hz <= freq_hz <= b.hi_hz:
            return b
    return None


@dataclass
class BandMemory:
    """Last frequency/mode per band (`[U:bands.c]` band-stack behavior)."""

    mem: dict = field(default_factory=dict)

    def recall(self, name: str) -> tuple[float, str]:
        b = band(name)
        return self.mem.get(b.name, (b.default_hz, b.default_mode))

    def store(self, freq_hz: float, mode: str):
        b = band_of(freq_hz)
        if b is not None:
            self.mem[b.name] = (float(freq_hz), mode)

    # checkpoint payload (plain python; rides in the host-side blob)
    def to_dict(self) -> dict:
        return dict(self.mem)

    @classmethod
    def from_dict(cls, d: dict) -> "BandMemory":
        return cls(mem={k: (float(v[0]), str(v[1])) for k, v in d.items()})
