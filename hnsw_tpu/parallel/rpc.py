"""TCP transport for multi-host slices.

Implements parallel/multihost.Transport over stdlib sockets so a
MultiHostIndex can reach slices in OTHER processes/hosts — the concrete
form of the reference's unimplemented transport sketch
(hnsw-extensions/hnsw-extensions.md:233-271, "Transport interface ...
gRPC" — here: no dependency, same two methods).

Wire format (both directions), designed to move numpy arrays without
copies or code execution — NO pickle:

    u32 header_len | header JSON (utf-8) | array frames back-to-back

The header is ``{"method": ..., "args": ..., "kw": ...}`` on requests
and ``{"ok": true, "result": ...}`` / ``{"ok": false, "error": ...}``
on responses, where values are encoded by ``_enc``:

    np.ndarray  -> {"__a": i}  (frame i: dtype/shape in "arrays"[i])
    tuple       -> {"__t": [...]}   (round-trips tuple keys)
    dict        -> {"__d": [[k, v], ...]}  (non-str keys survive)
    scalars/str/None/bool/list pass through as JSON

Trust model: the server executes a WHITELISTED set of index methods for
anyone who can connect — run it inside your cluster boundary, exactly
like the reference's sketched gRPC service.
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hnsw_tpu.parallel.multihost import Transport

#: methods a SliceServer will dispatch (the SearchableIndex protocol
#: plus introspection) — everything MultiHostIndex uses.
ALLOWED_METHODS = ("batch_add", "add", "batch_delete", "delete",
                   "batch_search", "search", "__len__", "stats")

_MAX_MSG = 1 << 31  # sanity bound on header length


def _enc(val, frames: List[np.ndarray]):
    if isinstance(val, np.ndarray):
        frames.append(np.ascontiguousarray(val))
        return {"__a": len(frames) - 1}
    if isinstance(val, (np.integer,)):
        return int(val)
    if isinstance(val, (np.floating,)):
        return float(val)
    if isinstance(val, tuple):
        return {"__t": [_enc(v, frames) for v in val]}
    if isinstance(val, list):
        return [_enc(v, frames) for v in val]
    if isinstance(val, dict):
        return {"__d": [[_enc(k, frames), _enc(v, frames)]
                        for k, v in val.items()]}
    if val is None or isinstance(val, (bool, int, float, str)):
        return val
    raise TypeError(f"rpc cannot encode {type(val).__name__}")


def _dec(val, frames: List[np.ndarray]):
    if isinstance(val, list):
        return [_dec(v, frames) for v in val]
    if isinstance(val, dict):
        if "__a" in val:
            return frames[val["__a"]]
        if "__t" in val:
            return tuple(_dec(v, frames) for v in val["__t"])
        if "__d" in val:
            return {_dec(k, frames): _dec(v, frames)
                    for k, v in val["__d"]}
    return val


def _send(sock: socket.socket, header: Dict[str, Any],
          frames: List[np.ndarray]) -> None:
    header = dict(header)
    header["arrays"] = [{"dtype": str(f.dtype), "shape": list(f.shape)}
                        for f in frames]
    hb = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(hb)))
    sock.sendall(hb)
    for f in frames:
        sock.sendall(memoryview(f).cast("B"))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed mid-message")
        got += r
    return bytes(buf)


def _recv(sock: socket.socket) -> Tuple[Dict[str, Any], List[np.ndarray]]:
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    if hlen > _MAX_MSG:
        raise ConnectionError("oversized header")
    header = json.loads(_recv_exact(sock, hlen).decode())
    frames = []
    for spec in header.get("arrays", ()):
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        raw = _recv_exact(sock, n) if n else b""
        frames.append(np.frombuffer(raw, dtype=dt).reshape(shape))
    return header, frames


class SliceServer:
    """Serves ONE slice index over TCP. ``serve_forever`` runs inline;
    ``start()`` runs it on a daemon thread and returns (host, port)."""

    def __init__(self, index: Any, host: str = "127.0.0.1",
                 port: int = 0):
        self.index = index
        # live connections, so shutdown() actually stops SERVING —
        # ThreadingTCPServer.shutdown only stops accepting; established
        # daemon-thread handlers would otherwise keep answering.
        self._conns: set = set()
        self._conns_lock = threading.Lock()

        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):  # one connection, many requests
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with outer._conns_lock:
                    outer._conns.add(sock)
                try:
                    while True:
                        try:
                            header, frames = _recv(sock)
                        except (ConnectionError, struct.error):
                            return
                        out_frames: List[np.ndarray] = []
                        try:
                            method = header["method"]
                            if method not in ALLOWED_METHODS:
                                raise PermissionError(
                                    f"method {method!r} not allowed")
                            args = _dec(header.get("args", []), frames)
                            kw = _dec(header.get("kw", {}), frames)
                            res = getattr(outer.index, method)(*args, **kw)
                            _send(sock, {"ok": True,
                                         "result": _enc(res, out_frames)},
                                  out_frames)
                        except Exception as e:  # report, keep serving
                            _send(sock, {"ok": False,
                                         "error": f"{type(e).__name__}: {e}"},
                                  [])
                finally:
                    with outer._conns_lock:
                        outer._conns.discard(sock)
                    sock.close()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.addr = self._server.server_address

    def start(self) -> Tuple[str, int]:
        t = threading.Thread(target=self._server.serve_forever,
                             daemon=True)
        t.start()
        return self.addr

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class SocketTransport(Transport):
    """Transport over persistent TCP connections, one per slice.

    ``addrs`` = [(host, port), ...] of running SliceServers. Connections
    are opened lazily and re-opened on failure with bounded retries
    (a restarted slice keeps serving — crash recovery stays the slice's
    own business via its DiskGraph/WAL persistence).

    Thread safety: calls to the SAME slice are serialized by a per-slice
    lock (the wire protocol is one-request-one-response per connection);
    calls to DIFFERENT slices run concurrently — the shape
    MultiHostIndex's concurrent fan-out needs.
    """

    def __init__(self, addrs: Sequence[Tuple[str, int]],
                 timeout: Optional[float] = 30.0,
                 connect_retries: int = 2,
                 retry_backoff: float = 0.2,
                 request_timeout: Optional[float] = None):
        """``timeout`` bounds CONNECT only. ``request_timeout`` is the
        per-request deadline once connected — default None (no
        deadline): a slice's first request can include its compiles,
        so a short request deadline would spuriously fail healthy
        slices during warmup. A request timeout raises TimeoutError and
        is NEVER reconnect-replayed (the request may still be
        executing)."""
        self.addrs = [tuple(a) for a in addrs]
        self.timeout = timeout
        self.request_timeout = request_timeout
        self.connect_retries = max(1, connect_retries)
        self.retry_backoff = retry_backoff
        self._socks: Dict[int, socket.socket] = {}
        self._locks = [threading.Lock() for _ in self.addrs]

    def num_slices(self) -> int:
        return len(self.addrs)

    def _connect(self, slice_id: int) -> socket.socket:
        last: Optional[Exception] = None
        for attempt in range(self.connect_retries):
            try:
                s = socket.create_connection(self.addrs[slice_id],
                                             timeout=self.timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                # switch from the connect timeout to the per-request
                # deadline (None = block: warmup compiles are normal)
                s.settimeout(self.request_timeout)
                return s
            except OSError as e:
                last = e
                if attempt + 1 < self.connect_retries:
                    time.sleep(self.retry_backoff * (attempt + 1))
        raise ConnectionError(
            f"slice {slice_id} unreachable at {self.addrs[slice_id]}: "
            f"{last}") from last

    def _drop(self, slice_id: int) -> None:
        s = self._socks.pop(slice_id, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _roundtrip(self, sock, method, args, kw):
        frames: List[np.ndarray] = []
        header = {"method": method, "args": _enc(list(args), frames),
                  "kw": _enc(dict(kw), frames)}
        _send(sock, header, frames)
        resp, rframes = _recv(sock)
        if not resp.get("ok"):
            raise RuntimeError(f"slice call failed: {resp.get('error')}")
        return _dec(resp.get("result"), rframes)

    def call(self, slice_id: int, method: str, *args, **kw):
        with self._locks[slice_id]:
            sock = self._socks.get(slice_id)
            try:
                if sock is None:
                    raise ConnectionError
                return self._roundtrip(sock, method, args, kw)
            except socket.timeout:
                # Deadline expired but the slice may STILL be executing
                # the request (e.g. a warmup compile) — the stream is
                # mid-frame and a replay could double-apply a write.
                # Drop the connection and surface the timeout as-is.
                self._drop(slice_id)
                raise TimeoutError(
                    f"slice {slice_id} request {method!r} exceeded "
                    f"request_timeout={self.request_timeout}s") from None
            except OSError:   # connection reset/closed — NOT timeout
                # stale/broken connection: reconnect and replay once.
                # Only safe because every wire method is idempotent-ish
                # at the index level (adds overwrite, deletes return
                # bool, searches are pure).
                self._drop(slice_id)
                sock = self._connect(slice_id)
                self._socks[slice_id] = sock
                try:
                    return self._roundtrip(sock, method, args, kw)
                except OSError:
                    self._drop(slice_id)
                    raise

    def close(self) -> None:
        for slice_id, lock in enumerate(self._locks):
            with lock:
                self._drop(slice_id)
