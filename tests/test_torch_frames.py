"""The port's wire layer (``hyperopt_tpu_torch.serve.frames``) against
the reference's (``hyperopt_tpu.serve.frames``): ``pack`` gives the same
bytes for every protocol value, ``unpack`` round-trips them, the same
values are refused with the same error type, ``read_frame`` fails typed
on an oversize length, garbage and a short read, and ``FrameConn``
resolves pipelined replies by rid, or FIFO for an rid-less peer."""

import io
import json
import math
import socketserver
import threading

import pytest

from hyperopt_tpu.serve import frames as J
from hyperopt_tpu_torch.serve import frames as F


def corpus():
    """Protocol values: nested maps, ints at each width boundary, +-inf
    and NaN, long strings, bytes, and the serve protocol's own shapes."""
    ints = [0, 1, -1, 127, 128, -128, -129, 255, 256, 2**15 - 1, -2**15, 2**16, 2**31 - 1,
            -2**31, 2**32, 2**53 + 1, 2**63 - 1, -2**63]
    floats = [0.0, -0.0, 1.5, -2.5e-300, 1e308, float("inf"), float("-inf"), 5e-324,
              0.1 + 0.2, 3.4028234663852886e38]
    return [
        None, True, False, *ints, *floats, "", "x" * 70000, "ünïcödé ✓", b"", b"\x00\xff" * 300,
        [], {}, [1, [2, [3, [None]]]],
        {"op": "ask", "study": "fmin-2", "rid": 7, "timeout": 30.0},
        {"ok": True, "tid": 3, "vals": {"x": -0.4372882843017578, "c": 1}, "rid": 2**40},
        {"nested": {"k": [1, {"d": 2, "e": [True, None, -0.0]}]}, "blob": b"\x00bytes"},
        {"results": {f"s{i}": {"ok": i % 2 == 0, "tid": i} for i in range(20)}},
        (1, 2.0, "three"),
    ]


@pytest.mark.parametrize("obj", corpus(), ids=lambda o: type(o).__name__)
def test_pack_is_the_reference_bytes_and_round_trips(obj):
    got = F.pack(obj)
    assert got == J.pack(obj)
    back = F.unpack(got)
    want = list(obj) if isinstance(obj, tuple) else obj
    if isinstance(obj, float) and math.isnan(obj):
        assert math.isnan(back)
    else:
        assert back == want and type(back) is type(want)
    assert J.unpack(got) == back


def test_nan_crosses_as_the_same_bytes():
    nan = float("nan")
    assert F.pack(nan) == J.pack(nan) and math.isnan(F.unpack(F.pack(nan)))
    doc = {"loss": nan, "vals": [nan, 1.0]}
    assert F.pack(doc) == J.pack(doc)


@pytest.mark.parametrize("bad", [object(), {"x": {1, 2}}, [1.0, complex(1, 2)], {"f": print}])
def test_non_protocol_values_are_refused_as_the_reference_refuses(bad):
    with pytest.raises(TypeError) as mine:
        F.pack(bad)
    with pytest.raises(TypeError) as ref:
        J.pack(bad)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("raw", [b"", b"\x99", b"\xdb\x00\x00\x00\x05ab", F.pack("x") + b"junk",
                                 F.pack({"a": 1})[:-2], b"\xdb\x00\x00\x00\x02\xff\xfe",
                                 b"\xd3\x00\x01"])
def test_unpack_garbage_is_a_frame_error(raw):
    with pytest.raises(F.FrameError):
        F.unpack(raw)
    with pytest.raises(J.FrameError):
        J.unpack(raw)


def test_read_frame_discipline():
    assert F.read_frame(io.BytesIO(b"")) is None  # clean EOF
    for raw in (b"\x00\x00\x00\x00",  # zero length
                (F.MAX_FRAME + 1).to_bytes(4, "big"),  # a hostile length must not allocate
                b"\x00\x00\x00\x08ab",  # a short body
                b"\x00\x00",  # a short prefix
                b"\x00\x00\x00\x02\x99\x99"):  # garbage
        with pytest.raises(F.FrameError):
            F.read_frame(io.BytesIO(raw))
    buf = io.BytesIO()
    F.write_frame(buf, {"ok": True, "x": 0.5})
    ref = io.BytesIO()
    J.write_frame(ref, {"ok": True, "x": 0.5})
    assert buf.getvalue() == ref.getvalue()
    buf.seek(0)
    assert F.read_frame(buf) == {"ok": True, "x": 0.5}
    assert (F.PROTO_V1, F.PROTO_V2, F.MAX_FRAME) == (J.PROTO_V1, J.PROTO_V2, J.MAX_FRAME)
    assert (F.DEFAULT_CONNECT_TIMEOUT, F.DEFAULT_READ_TIMEOUT) == (
        J.DEFAULT_CONNECT_TIMEOUT, J.DEFAULT_READ_TIMEOUT)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class _ReorderHandler(socketserver.StreamRequestHandler):
    """A binary peer that answers three pipelined requests in reverse."""

    def handle(self):
        self.rfile.readline()  # the hello line
        self.wfile.write((json.dumps({"ok": True, "proto": 2}) + "\n").encode())
        self.wfile.flush()
        reqs = [F.read_frame(self.rfile) for _ in range(3)]
        for req in reversed(reqs):
            F.write_frame(self.wfile, {"ok": True, "echo": req["n"], "rid": req["rid"]})
        self.wfile.flush()


class _OldJsonHandler(socketserver.StreamRequestHandler):
    """A JSON-line peer that knows no ``hello``, answers in order and
    echoes no rid."""

    def handle(self):
        for raw in self.rfile:
            req = json.loads(raw)
            reply = ({"ok": False, "error": "unknown op 'hello'"} if req.get("op") == "hello"
                     else {"ok": True, "echo": req.get("n")})
            self.wfile.write((json.dumps(reply) + "\n").encode())
            self.wfile.flush()


def _peer(handler):
    srv = _Server(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _conn(srv):
    _sock, f = F.dial(*srv.server_address[:2], connect_timeout=10, read_timeout=10)
    return F.FrameConn(f)


def test_pipelined_replies_out_of_order_land_on_their_futures():
    srv = _peer(_ReorderHandler)
    conn = _conn(srv)
    try:
        assert conn.binary is True
        futs = [conn.submit({"op": "x", "n": i}) for i in range(3)]
        assert conn.drain(futs[0])["echo"] == 0  # the last reply arrives first
        assert [f.result(timeout=0)["echo"] for f in futs] == [0, 1, 2]
    finally:
        conn.close()
        srv.shutdown()
        srv.server_close()


def test_an_ridless_peer_resolves_fifo():
    srv = _peer(_OldJsonHandler)
    conn = _conn(srv)
    try:
        assert conn.binary is False  # the peer declined hello: JSON lines
        futs = [conn.submit({"op": "x", "n": i}) for i in range(4)]
        assert [conn.drain(f)["echo"] for f in futs] == [0, 1, 2, 3]
    finally:
        conn.close()
        srv.shutdown()
        srv.server_close()


def test_close_fails_requests_still_in_flight():
    srv = _peer(_OldJsonHandler)
    conn = _conn(srv)
    try:
        fut = conn.submit({"op": "x", "n": 1})
        conn.close()
        with pytest.raises(ConnectionError):
            fut.result(timeout=0)
    finally:
        srv.shutdown()
        srv.server_close()
