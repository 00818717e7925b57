"""``hyperopt-tpu-torch-scope``: scrape metrics and tail spans from a live
port server, or read a flight-log file.

The port's copy of :mod:`hyperopt_tpu.obs.cli` (its output for the same
replies and files is the reference's).  Examples::

    # a server's metrics, Prometheus text
    hyperopt-tpu-torch-scope metrics --port 7077

    # the last 20 spans of a live server's flight recorder
    hyperopt-tpu-torch-scope trace --port 7077 --tail 20

    # a flight-recorder file, offline (post-mortem)
    hyperopt-tpu-torch-scope flight /var/run/study-root/flight.wal --tail 50
"""

from __future__ import annotations

import argparse
import json


def _rpc(host, port, req, timeout=30.0):
    # dial() carries connect and read deadlines: a hung server surfaces
    # as NetworkTimeout instead of stranding the console
    from ..serve.frames import dial

    sock, f = dial(
        host, int(port), connect_timeout=timeout, read_timeout=timeout,
    )
    try:
        f.write((json.dumps(req) + "\n").encode("utf-8"))
        f.flush()
        line = f.readline()
    finally:
        f.close()
        sock.close()
    if not line:
        raise ConnectionError(f"{host}:{port} closed the connection")
    return json.loads(line)


def _span_line(span):
    fixed = {"name", "ts", "dur_ms", "seq"}
    ids = " ".join(
        f"{k}={span[k]}" for k in sorted(span) if k not in fixed
    )
    dur = f" {span['dur_ms']:.3f}ms" if "dur_ms" in span else ""
    return f"{span.get('ts', 0):.6f} {span['name']}{dur} {ids}".rstrip()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="hyperopt-tpu-torch-scope",
        description="scrape Prometheus-style metrics from a port server, tail "
        "trace spans, or read a flight-log file.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    for name, doc in (
        ("metrics", "scrape /metrics-style exposition over the "
         "JSON-line protocol"),
        ("trace", "tail the flight recorder of a live target"),
    ):
        p = sub.add_parser(name, help=doc)
        p.add_argument("--host", default="127.0.0.1")
        p.add_argument("--port", type=int, required=True)
        p.add_argument("--timeout", type=float, default=30.0)
        p.add_argument("--json", action="store_true",
                       help="print raw JSON instead of text")
        if name == "trace":
            p.add_argument("--tail", type=int, default=50)

    p = sub.add_parser(
        "flight", help="read a flight-recorder file offline"
    )
    p.add_argument("path")
    p.add_argument("--tail", type=int, default=None)
    p.add_argument("--json", action="store_true")

    args = parser.parse_args(argv)

    if args.cmd == "flight":
        from .flightrec import read_flight_log

        spans = read_flight_log(args.path, tail=args.tail)
        if args.json:
            print(json.dumps(spans))
        else:
            for s in spans:
                print(_span_line(s))
        return 0

    if args.cmd == "metrics":
        reply = _rpc(
            args.host, args.port, {"op": "metrics"}, timeout=args.timeout
        )
        if not reply.get("ok"):
            print(json.dumps(reply))
            return 1
        if args.json:
            print(json.dumps(reply.get("metrics", [])))
        else:
            print(reply.get("text", ""), end="")
        return 0

    # trace
    reply = _rpc(
        args.host, args.port,
        {"op": "trace", "tail": args.tail}, timeout=args.timeout,
    )
    if not reply.get("ok"):
        print(json.dumps(reply))
        return 1
    spans = reply.get("spans", [])
    if args.json:
        print(json.dumps(spans))
    else:
        for s in spans:
            print(_span_line(s))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
