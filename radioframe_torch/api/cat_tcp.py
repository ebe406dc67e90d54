"""CAT over TCP (counterpart of ``radioframe/api/cat_tcp.py``).

The reference serves its Kenwood-dialect CAT protocol over a USB CDC ACM
endpoint; rig-control clients (hamlib/wsjtx/fldigi) open the port and stream
';'-terminated ASCII commands. Here the same dialect (api/cat.py::CatServer)
is served over a TCP socket, rigctld-style: any number of clients connect,
each gets its own receive buffer (commands may be split across packets — a
frame completes only at ';'), and all dispatch into one shared CatServer
under a lock so control writes never interleave mid-command with the
streaming data plane.

Usage:

    srv = CatTcpServer(CatServer(trx))
    host, port = srv.start()          # port=0 -> ephemeral, returned here
    ... clients connect, stream runs concurrently ...
    srv.stop()
"""

from __future__ import annotations

import socket
import threading

from radioframe_torch.api.cat import CatServer


class CatTcpServer:
    def __init__(self, cat: CatServer, host: str = "127.0.0.1", port: int = 0):
        self.cat = cat
        self.host, self.port = host, port
        # serializes CAT dispatch against the data plane: the stream loop
        # may hold this while snapshotting freq/mode/PTT for a block
        self.lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> tuple[str, int]:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(4)
        s.settimeout(0.2)  # so the accept loop can observe _stop
        self._sock = s
        self.host, self.port = s.getsockname()
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self.host, self.port

    def stop(self):
        self._stop.set()
        if self._sock is not None:
            self._sock.close()
        for t in list(self._threads):  # accept loop may still append briefly
            t.join(timeout=2.0)
        self._threads.clear()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- socket plumbing ------------------------------------------------------

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except (TimeoutError, socket.timeout):
                continue
            except OSError:
                return  # socket closed by stop()
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True)
            t.start()
            # prune finished client threads so long-lived servers with
            # reconnecting clients (hamlib polling) don't accumulate them
            self._threads[:] = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _client_loop(self, conn: socket.socket):
        buf = b""
        conn.settimeout(0.2)
        with conn:
            while not self._stop.is_set():
                try:
                    data = conn.recv(4096)
                except (TimeoutError, socket.timeout):
                    continue
                except OSError:
                    return
                if not data:
                    return  # client hung up
                buf += data
                # frames complete only at ';' — keep the partial tail
                head, sep, buf = buf.rpartition(b";")
                if not sep:
                    continue
                with self.lock:
                    resp = self.cat.handle(head.decode("ascii", "replace") + ";")
                if resp:
                    try:
                        conn.sendall(resp.encode("ascii"))
                    except OSError:
                        return
