"""The wire layer of the port's socket transport: negotiated binary
frames and pipelining.

The port's copy of :mod:`hyperopt_tpu.serve.frames`, byte for byte on
the wire: a client and a server of either package speak to each other.

* **Version negotiation** rides the JSON-line protocol itself.  A new
  client's first line is ``{"op": "hello", "proto": 2}``; a server that
  speaks frames replies ``{"ok": true, "proto": 2}`` and both sides
  switch to binary frames for the rest of the connection.  A server
  that does not answers the unknown op with ``ok: false`` and the client
  stays on JSON lines; a client that never says hello keeps the server
  on JSON lines for that connection.
* **Binary frames** are a 4-byte big-endian length prefix followed by a
  msgpack-style payload: single-byte type tags (msgpack's wide forms)
  and fixed-width ``struct`` packs for the values the serve protocol
  ships (None/bool/int/float/str/bytes/list/dict).  A float crosses as
  a float64, so a value's bits survive the wire.
* **Pipelining**: every request carries a monotone ``rid``, every reply
  echoes it, and :class:`FrameConn` keeps many requests in flight on
  one connection, resolving each reply onto its future in whatever
  order it lands.  A JSON-line peer that answers in order without
  echoing rids resolves the oldest pending future (FIFO).

Failure discipline: a frame whose declared length exceeds
:data:`MAX_FRAME` (or is zero), a payload that does not decode, and a
short read (EOF mid-frame) raise :class:`FrameError`; the server replies
with ``error_type: "FrameError"`` and closes, never hangs.
"""

from __future__ import annotations

import json
import socket
import struct

from ..exceptions import HyperoptTpuError, NetworkTimeout, Overloaded, PeerUnreachable

__all__ = [
    "PROTO_V1",
    "PROTO_V2",
    "MAX_FRAME",
    "DEFAULT_CONNECT_TIMEOUT",
    "DEFAULT_READ_TIMEOUT",
    "FrameError",
    "DeadlineFile",
    "dial",
    "pack",
    "unpack",
    "read_frame",
    "write_frame",
    "FrameConn",
]

PROTO_V1 = 1  # JSON-lines, lockstep (the original seam)
PROTO_V2 = 2  # length-prefixed binary frames, pipelined

#: every outbound socket gets both deadlines: nothing in the serve stack
#: may block forever on a silent peer
DEFAULT_CONNECT_TIMEOUT = 5.0
DEFAULT_READ_TIMEOUT = 30.0

#: refuse to allocate for a frame longer than this (a malformed or
#: hostile length prefix must be a typed error, not an OOM)
MAX_FRAME = 64 * 1024 * 1024

# msgpack's wide-form type tags (the subset the serve protocol ships)
_T_NIL = 0xC0
_T_FALSE = 0xC2
_T_TRUE = 0xC3
_T_BIN = 0xC6    # + u32 length + bytes
_T_FLOAT = 0xCB  # + f64 big-endian
_T_INT = 0xD3    # + i64 big-endian
_T_STR = 0xDB    # + u32 length + utf-8 bytes
_T_LIST = 0xDD   # + u32 count + items
_T_MAP = 0xDF    # + u32 count + key/value pairs

_U32 = struct.Struct(">I")
_F64 = struct.Struct(">d")
_I64 = struct.Struct(">q")


class FrameError(HyperoptTpuError):
    """A binary frame could not be read or decoded: oversized or
    garbled length prefix, truncated payload (EOF mid-frame), unknown
    type tag, or an undecodable body.  The transport converts this
    into a typed error reply (``error_type: "FrameError"``) and closes
    the connection -- past a framing error the stream offset is
    meaningless, so resynchronization is not attempted."""


# ---------------------------------------------------------------------------
# dialing: deadlines on every outbound socket
# ---------------------------------------------------------------------------


class DeadlineFile:
    """File-object proxy that converts a missed socket deadline into
    the typed :class:`~..exceptions.NetworkTimeout`.

    ``socket.create_connection(timeout=...)`` leaves the timeout set on
    the socket, so every ``makefile`` read/write inherits it -- but a
    miss surfaces as ``socket.timeout``, which callers would have to
    distinguish from real ``OSError`` transport failures by hand.  This
    proxy does the conversion once, at the transport seam, so the
    failover/retry machinery matches on the typed hierarchy."""

    def __init__(self, f, peer=None):
        self._f = f
        self._peer = peer

    def _timeout(self, op, e):
        raise NetworkTimeout(
            f"socket {op} missed its deadline"
            + (f" (peer {self._peer})" if self._peer else "")
        ) from e

    def read(self, n=-1):
        try:
            return self._f.read(n)
        except socket.timeout as e:
            self._timeout("read", e)

    def readline(self, limit=-1):
        try:
            return self._f.readline(limit)
        except socket.timeout as e:
            self._timeout("read", e)

    def write(self, b):
        try:
            return self._f.write(b)
        except socket.timeout as e:
            self._timeout("write", e)

    def flush(self):
        try:
            self._f.flush()
        except socket.timeout as e:
            self._timeout("write", e)

    def close(self):
        self._f.close()

    @property
    def closed(self):
        return self._f.closed

    def __getattr__(self, name):
        return getattr(self._f, name)


def dial(host, port, connect_timeout=DEFAULT_CONNECT_TIMEOUT,
         read_timeout=DEFAULT_READ_TIMEOUT, net_plan=None, key=None):
    """Open one deadline-armed transport to ``(host, port)``.

    The one connection-creation seam of the serve stack (the study
    client, the scope console): connect
    failures surface typed :class:`~..exceptions.PeerUnreachable`, the
    connect deadline stays on the socket as the read/write deadline
    (missed reads surface typed :class:`~..exceptions.NetworkTimeout`
    via :class:`DeadlineFile`), and an optional
    :class:`~hyperopt_tpu_torch.distributed.netfaults.NetFaultPlan` wraps
    the handle, so chaos tests inject wire faults at the production seam.

    Returns ``(sock, f)`` -- the socket (for callers that need
    ``close``/peer info) and the wrapped ``rwb`` file handle ready for
    :class:`FrameConn`."""
    try:
        sock = socket.create_connection((host, port), timeout=connect_timeout)
    except socket.timeout as e:
        raise PeerUnreachable(
            f"connect to {host}:{port} missed its {connect_timeout}s deadline"
        ) from e
    except OSError as e:
        raise PeerUnreachable(f"connect to {host}:{port} failed: {e}") from e
    sock.settimeout(read_timeout)
    f = sock.makefile("rwb")
    if net_plan is not None:
        f = net_plan.wrap(f, sock=sock, key=key)
    return sock, DeadlineFile(f, peer=f"{host}:{port}")


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def _pack_into(obj, out):
    if obj is None:
        out.append(bytes([_T_NIL]))
    elif obj is True:
        out.append(bytes([_T_TRUE]))
    elif obj is False:
        out.append(bytes([_T_FALSE]))
    elif isinstance(obj, int):
        out.append(bytes([_T_INT]) + _I64.pack(obj))
    elif isinstance(obj, float):
        out.append(bytes([_T_FLOAT]) + _F64.pack(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.append(bytes([_T_STR]) + _U32.pack(len(b)) + b)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(bytes([_T_BIN]) + _U32.pack(len(obj)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(bytes([_T_LIST]) + _U32.pack(len(obj)))
        for item in obj:
            _pack_into(item, out)
    elif isinstance(obj, dict):
        out.append(bytes([_T_MAP]) + _U32.pack(len(obj)))
        for k, v in obj.items():
            _pack_into(k, out)
            _pack_into(v, out)
    else:
        raise TypeError(
            f"frame codec cannot encode {type(obj).__name__!r} "
            "(the wire protocol ships JSON-able values only)"
        )


def pack(obj):
    """Encode one protocol value to bytes."""
    out = []
    _pack_into(obj, out)
    return b"".join(out)


def _unpack_from(buf, pos):
    try:
        tag = buf[pos]
    except IndexError:
        raise FrameError("truncated frame: type tag past end of payload")
    pos += 1
    try:
        if tag == _T_NIL:
            return None, pos
        if tag == _T_TRUE:
            return True, pos
        if tag == _T_FALSE:
            return False, pos
        if tag == _T_INT:
            return _I64.unpack_from(buf, pos)[0], pos + 8
        if tag == _T_FLOAT:
            return _F64.unpack_from(buf, pos)[0], pos + 8
        if tag in (_T_STR, _T_BIN):
            n = _U32.unpack_from(buf, pos)[0]
            pos += 4
            raw = buf[pos:pos + n]
            if len(raw) != n:
                raise FrameError("truncated frame: short str/bin body")
            return (
                raw.decode("utf-8") if tag == _T_STR else bytes(raw),
                pos + n,
            )
        if tag == _T_LIST:
            n = _U32.unpack_from(buf, pos)[0]
            pos += 4
            items = []
            for _ in range(n):
                item, pos = _unpack_from(buf, pos)
                items.append(item)
            return items, pos
        if tag == _T_MAP:
            n = _U32.unpack_from(buf, pos)[0]
            pos += 4
            d = {}
            for _ in range(n):
                k, pos = _unpack_from(buf, pos)
                v, pos = _unpack_from(buf, pos)
                d[k] = v
            return d, pos
    except struct.error as e:
        raise FrameError(f"truncated frame: {e}") from e
    except UnicodeDecodeError as e:
        raise FrameError(f"undecodable frame string: {e}") from e
    raise FrameError(f"unknown frame type tag 0x{tag:02x}")


def unpack(buf):
    """Decode one protocol value; the payload must be exactly one."""
    obj, pos = _unpack_from(buf, 0)
    if pos != len(buf):
        raise FrameError(
            f"frame payload has {len(buf) - pos} trailing byte(s)"
        )
    return obj


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def _read_exact(rfile, n):
    """n bytes or None at a clean EOF boundary; FrameError mid-read."""
    chunks, got = [], 0
    while got < n:
        chunk = rfile.read(n - got)
        if not chunk:
            if got == 0:
                return None
            raise FrameError(
                f"truncated frame: EOF after {got}/{n} byte(s)"
            )
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(rfile):
    """One decoded frame, or None at clean EOF (connection closed
    between frames).  Raises :class:`FrameError` for anything torn."""
    head = _read_exact(rfile, 4)
    if head is None:
        return None
    n = _U32.unpack(head)[0]
    if n == 0 or n > MAX_FRAME:
        raise FrameError(
            f"frame length {n} out of range (1..{MAX_FRAME}) -- "
            "malformed prefix or a non-frame peer"
        )
    payload = _read_exact(rfile, n)
    if payload is None:
        raise FrameError("truncated frame: EOF before payload")
    return unpack(payload)


def write_frame(wfile, obj):
    payload = pack(obj)
    wfile.write(_U32.pack(len(payload)) + payload)


# ---------------------------------------------------------------------------
# the pipelined client connection
# ---------------------------------------------------------------------------


class FrameConn:
    """One negotiated client connection with request pipelining.

    ``submit(req)`` writes the request (stamped with a fresh ``rid``)
    and returns a Future immediately; any number may be in flight.
    ``call(req)`` is submit + drain until that reply lands.  Replies
    resolve by rid match; an rid-less reply (old JSON-line server,
    which answers strictly in order) resolves the oldest pending
    future.  Not thread-safe: one connection per driving thread.
    """

    def __init__(self, f, negotiate=True):
        self.f = f
        self.binary = False
        self._next_rid = 0
        self._pending = {}  # rid -> Future
        self._order = []    # FIFO of rids for rid-less (v1) replies
        if negotiate:
            self._hello()

    def _hello(self):
        """One JSON line each way; switch to binary iff the server
        speaks proto >= 2 (an old server's unknown-op error leaves the
        connection in JSON-line mode -- that IS the fallback)."""
        self.f.write(
            (json.dumps({"op": "hello", "proto": PROTO_V2}) + "\n")
            .encode("utf-8")
        )
        self.f.flush()
        line = self.f.readline()
        if not line:
            raise ConnectionError("backend closed during hello")
        try:
            reply = json.loads(line)
        except ValueError as e:
            raise ConnectionError(f"garbled hello reply: {e}") from e
        if not reply.get("ok") and reply.get("error_type") == "Overloaded":
            # the server front's connection-cap refusal: a typed,
            # retryable rejection sent before negotiation -- not an old
            # server's unknown-op error, which stays the silent
            # JSON-line fallback
            raise Overloaded(
                reply.get("error") or "connection refused at the cap",
                retry_after=reply.get("retry_after"),
                reason=reply.get("reason") or "max_connections",
            )
        self.binary = bool(
            reply.get("ok") and int(reply.get("proto", PROTO_V1)) >= PROTO_V2
        )

    def submit(self, req):
        from concurrent.futures import Future

        rid = self._next_rid
        self._next_rid += 1
        fut = Future()
        self._pending[rid] = fut
        self._order.append(rid)
        wire = dict(req, rid=rid)
        if self.binary:
            write_frame(self.f, wire)
        else:
            self.f.write((json.dumps(wire) + "\n").encode("utf-8"))
        self.f.flush()
        return fut

    def _read_one(self):
        """Pull the next reply off the wire and resolve its future."""
        if self.binary:
            reply = read_frame(self.f)
            if reply is None:
                raise ConnectionError("backend closed the connection")
        else:
            line = self.f.readline()
            if not line:
                raise ConnectionError("backend closed the connection")
            reply = json.loads(line)
        rid = reply.get("rid") if isinstance(reply, dict) else None
        if rid is None and self._order:
            rid = self._order[0]
        fut = self._pending.pop(rid, None)
        if rid in self._order:
            self._order.remove(rid)
        if fut is not None:
            fut.set_result(reply)
        return reply

    def drain(self, fut):
        """Read replies until ``fut`` resolves; returns its reply."""
        while not fut.done():
            self._read_one()
        return fut.result()

    def call(self, req):
        return self.drain(self.submit(req))

    def close(self):
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(
                    ConnectionError("connection closed with the "
                                    "request still in flight")
                )
        self._pending.clear()
        self._order.clear()
        try:
            self.f.close()
        except OSError:
            pass
