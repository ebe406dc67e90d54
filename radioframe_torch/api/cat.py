"""CAT text-protocol adapter (counterpart of ``radioframe/api/cat.py``):
the same Kenwood dialect and responses, over the port's Transceiver.

The reference exposes a Kenwood-style (TS-480-like) CAT protocol over USB
CDC; rig-control software drives it with semicolon-terminated ASCII commands.
The framework's primary control surface is the Python `Transceiver` API,
but this adapter speaks the wire protocol for drop-in compatibility with CAT
clients (hamlib-style usage): feed it command strings, get response strings.

Protocol notes: the command set below is the common Kenwood core (FA/FB/MD/
IF/TX/RX/SM/ID/FR/FT/AI/PS/KS). The reference's exact dialect is [MED]
confidence (SURVEY.md §0 — mount empty); the `IF` response layout here is the
TS-480 38-byte frame. Unknown commands answer `?;` per Kenwood convention.
"""

from __future__ import annotations

import numpy as np

from radioframe_torch.api.transceiver import Transceiver

# Kenwood mode digits <-> radioframe demod modes
MODE_TO_DIGIT = {"lsb": "1", "ssb": "2", "cw": "3", "nfm": "4", "am": "5",
                 "sam": "5"}
DIGIT_TO_MODE = {"1": "lsb", "2": "ssb", "3": "cw", "4": "nfm", "5": "am"}


class CatServer:
    """Stateless command dispatcher bound to one Transceiver channel.

    >>> cat = CatServer(trx)
    >>> cat.handle("FA00007100000;")   # set VFO A 7.1 MHz
    ''
    >>> cat.handle("FA;")
    'FA00007100000;'
    """

    def __init__(self, trx: Transceiver, channel: int = 0):
        self.trx = trx
        self.ch = channel
        self._ai = 0
        self._keyer_wpm = 20

    # -- wire interface -------------------------------------------------------

    def handle(self, data: str) -> str:
        """Process a buffer of ';'-terminated commands; returns responses."""
        out = []
        for cmd in data.split(";"):
            cmd = cmd.strip()
            if cmd:
                out.append(self._dispatch(cmd))
        return "".join(out)

    # -- dispatch --------------------------------------------------------------

    def _dispatch(self, cmd: str) -> str:
        name, arg = cmd[:2].upper(), cmd[2:]
        fn = getattr(self, f"_cmd_{name.lower()}", None)
        if fn is None:
            return "?;"
        try:
            resp = fn(arg)
        except (ValueError, IndexError):
            # malformed argument (e.g. corrupted frame, non-numeric digits):
            # answer '?;' per Kenwood convention instead of crashing the server
            return "?;"
        return resp if resp is not None else ""

    # -- commands ---------------------------------------------------------------

    def _cmd_fa(self, arg):  # VFO A frequency
        if arg:
            self.trx.tune(self.ch, float(int(arg)))
            return None
        return f"FA{int(round(self.trx._vfo_a[self.ch])):011d};"

    def _cmd_fb(self, arg):  # VFO B frequency
        if arg:
            self.trx.vfo_b(self.ch, float(int(arg)))
            return None
        return f"FB{int(round(self.trx._vfo_b[self.ch])):011d};"

    def _cmd_md(self, arg):  # mode
        if arg:
            mode = DIGIT_TO_MODE.get(arg[0])
            if mode is None:
                return "?;"
            self.trx.set_mode(self.ch, mode)
            return None
        return f"MD{MODE_TO_DIGIT[self.trx.mode(self.ch)]};"

    def _cmd_tx(self, arg):  # key PTT
        self.trx.ptt(True)
        return None

    def _cmd_rx(self, arg):  # unkey PTT
        self.trx.ptt(False)
        return None

    def _cmd_fr(self, arg):  # receive VFO (0=A, 1=B) — absolute, idempotent
        if arg:
            if arg[0] not in "01":
                return "?;"
            self.trx.select_rx_vfo(self.ch, int(arg[0]))
            return None
        return f"FR{self.trx.rx_vfo(self.ch)};"

    def _cmd_ft(self, arg):  # transmit VFO -> split on/off
        if arg:
            self.trx.split(self.ch, arg[0] == "1")
            return None
        return f"FT{int(bool(self.trx._split[self.ch]))};"

    def _cmd_id(self, arg):  # radio identity (TS-480 answers 020)
        return "ID020;"

    def _cmd_ai(self, arg):  # auto-information
        if arg:
            self._ai = int(arg[0])
            return None
        return f"AI{self._ai};"

    def _cmd_ps(self, arg):  # power status
        return "PS1;"

    def _cmd_ks(self, arg):  # keyer speed (WPM)
        if arg:
            self._keyer_wpm = max(4, min(60, int(arg)))
            return None
        return f"KS{self._keyer_wpm:03d};"

    def _cmd_sm(self, arg):  # S-meter (0000..0030 scale)
        aux = self.trx.last_aux
        if aux is None:
            return "SM00000;"
        pw = float(aux["power_in"][self.ch])
        # map S0..S9+30 onto 0..30 (reference LCD bar resolution)
        dbm = 10.0 * np.log10(max(pw, 1e-30))
        level = int(np.clip((dbm + 127.0) / 3.0, 0, 30))
        return f"SM0{level:04d};"

    def _cmd_if(self, arg):  # TS-480 38-byte status frame
        t = self.trx
        freq = int(round(t.rx_frequency(self.ch)))
        rit = int(round(t._rit[self.ch]))
        rit_s = f"{'+' if rit >= 0 else '-'}{abs(rit):04d}"
        parts = (
            f"IF{freq:011d}",          # P1 frequency
            "     ",                    # P2 frequency step (unused, 5 sp)
            rit_s,                      # P3 RIT/XIT offset
            "1" if t._rit[self.ch] else "0",   # P4 RIT on
            "1" if t._xit[self.ch] else "0",   # P5 XIT on
            "000",                      # P6/P7 memory bank/channel
            "1" if t.transmitting else "0",    # P8 TX/RX
            MODE_TO_DIGIT[t.mode(self.ch)],    # P9 mode
            str(t.rx_vfo(self.ch)),     # P10 receive VFO (0=A, 1=B)
            "0",                        # P11 scan
            "1" if t._split[self.ch] else "0", # P12 split
            "0", "00", "0",             # P13 tone, P14 tone no, P15 shift
        )
        return "".join(parts) + ";"
