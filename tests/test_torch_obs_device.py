"""The port's device utilities against the reference's: the serve
scheduler's device-metrics twin (``device_metrics_every``), the compiled
loop's ``metrics_registry=`` rows (``obs/device.py``), ``StepTimer`` /
``instrument_algo`` / ``device_trace`` (``utils/profiling.py``) and the
``hyperopt-tpu-torch-scope`` console (``obs/cli.py``), as
``tests/test_obs.py`` and ``tests/test_observability.py`` hold the
reference's."""

import json
import math
import os
import threading

import numpy as np
import pytest

import hyperopt_tpu_torch as H
from hyperopt_tpu import hp as jhp
from hyperopt_tpu.device_loop import compile_fmin as j_compile_fmin
from hyperopt_tpu.obs import FlightRecorder as JFlightRecorder
from hyperopt_tpu.obs import MetricsRegistry as JRegistry
from hyperopt_tpu.obs import cli as j_cli
from hyperopt_tpu.serve import SuggestService as JService
from hyperopt_tpu_torch import hp
from hyperopt_tpu_torch.device_loop import compile_fmin
from hyperopt_tpu_torch.obs import FlightRecorder, MetricsRegistry
from hyperopt_tpu_torch.obs import cli as t_cli
from hyperopt_tpu_torch.serve import SuggestService
from hyperopt_tpu_torch.serve.service import serve_forever
from hyperopt_tpu_torch.utils.profiling import StepTimer, device_trace, instrument_algo

ALGO_KW = dict(n_cand=8, n_cand_cat=4)
# the reference's scenario space has a log-space dim, whose prior draws
# the port makes with PyTorch's exp (within 1e-6 of XLA's,
# test_torch_serve_batched.py): the best loss carries that much
LOG_RTOL = 1e-6


def space(h):
    return {"x": h.uniform("x", -5, 5), "lr": h.loguniform("lr", -5, 0),
            "c": h.choice("c", [0, 1])}


def loss_fn(vals):
    return vals["x"] ** 2 / 10 + abs(float(np.log(vals["lr"])) + 2) / 3


def drive(svc, handles, rounds, streams=None):
    for _ in range(rounds):
        futs = [(h, h.ask_async()) for h in handles]
        svc.pump()
        for h, f in futs:
            tid, vals = f.result(timeout=30)
            if streams is not None:
                streams.setdefault(h.name, []).append(vals)
            h.tell(tid, loss_fn(vals))


def twin_run(make, every, rounds=4):
    svc = make(every)
    handles = [svc.create_study(f"s{i}", seed=i) for i in range(3)]
    streams = {}
    drive(svc, handles, rounds, streams)
    s = svc.scheduler
    out = (s.dispatch_count, s.device_metric_dispatches,
           {r["name"]: r for r in svc.metrics_rows()}, streams, s._device_metrics_fn)
    svc.shutdown()
    return out


def port_service(every):
    return SuggestService(space(hp), max_batch=4, background=False, n_startup_jobs=2,
                          device_metrics_every=every, device="cpu", **ALGO_KW)


def ref_service(every):
    return JService(space(jhp), max_batch=4, background=False, n_startup_jobs=2,
                    device_metrics_every=every, **ALGO_KW)


TWIN_ROWS = ("obs_device_events_total", "serve_device_active_slots", "serve_device_trials_done",
             "serve_device_metric_dispatches_total", "serve_dispatch_total")


def test_twin_cadence_and_zero_when_off_rows_equal_the_reference():
    d_off, twin_off, rows_off, _, fn_off = twin_run(port_service, 0)
    assert (d_off, twin_off) == (4, 0) and fn_off is None  # off: never built, never run
    assert "serve_device_best_loss" not in rows_off
    d_on, twin_on, rows, _, _ = twin_run(port_service, 2)
    assert d_on == 4 and twin_on == 2  # cadence 2: rounds 2 and 4
    _, _, ref_rows, _, _ = twin_run(ref_service, 2)
    assert {k: rows[k]["value"] for k in TWIN_ROWS} == {k: ref_rows[k]["value"] for k in TWIN_ROWS}
    assert rows["obs_device_events_total"]["value"] == 2
    assert rows["serve_device_active_slots"]["value"] == 3
    assert math.isclose(rows["serve_device_best_loss"]["value"],
                        ref_rows["serve_device_best_loss"]["value"], rel_tol=LOG_RTOL)


def test_streams_are_bitwise_with_the_twin_on_and_off():
    *_, off, _ = twin_run(port_service, 0, rounds=5)
    *_, on, _ = twin_run(port_service, 1, rounds=5)
    assert on == off


def test_twin_events_reach_an_armed_recorder():
    rec = FlightRecorder()
    svc = SuggestService(space(hp), max_batch=4, background=False, n_startup_jobs=2,
                         device_metrics_every=1, recorder=rec, device="cpu", **ALGO_KW)
    drive(svc, [svc.create_study("s0", seed=0)], 2)
    svc.shutdown()
    events = [s for s in rec.tail() if s["name"] == "device.metrics"]
    assert [e["trials_done"] for e in events] == [0, 1]
    assert all(e["active_slots"] == 1 for e in events)


def test_metrics_registry_adapter_rows_equal_the_reference():
    """``compile_fmin(metrics_registry=)`` on rand's stream (bitwise across
    the packages): 16 evals in chunks of 8 steps' worth, two rows."""
    kw = dict(max_evals=16, batch_size=4, n_startup_jobs=2, n_EI_candidates=4, chunk_size=8,
              algo="rand")
    reg, jreg = MetricsRegistry("dl"), JRegistry("dl")
    out = compile_fmin(lambda cfg: (cfg["x"] - 1.0) ** 2, {"x": hp.uniform("x", -5.0, 5.0)},
                       metrics_registry=reg, device="cpu", **kw)(seed=3)
    jout = j_compile_fmin(lambda cfg: (cfg["x"] - 1.0) ** 2, {"x": jhp.uniform("x", -5.0, 5.0)},
                          metrics_registry=jreg, **kw)(seed=3)
    assert np.array_equal(np.asarray(out["losses"]), np.asarray(jout["losses"]))
    rows = {r["name"]: r["value"] for r in reg.collect()}
    jrows = {r["name"]: r["value"] for r in jreg.collect()}
    for name in ("obs_device_events_total", "device_loop_trials_done", "device_loop_best_loss"):
        assert rows[name] == jrows[name], name
    assert rows["obs_device_events_total"] == 2 and rows["device_loop_trials_done"] == 16
    assert rows["device_loop_best_loss"] == float(np.min(out["losses"]))
    assert rows["device_loop_trials_per_sec"] > 0


def test_step_timer_and_instrumented_algo():
    timer = StepTimer()
    timed = instrument_algo(H.rand.suggest, timer)
    H.fmin(lambda x: x**2, hp.uniform("x", -1, 1), algo=timed, max_evals=5, trials=H.Trials(),
           rstate=np.random.default_rng(0), show_progressbar=False, device="cpu")
    s = timer.summary()["suggest"]
    assert s["count"] == 5 and s["total_s"] >= 5 * s["min_s"]
    assert timed.__name__ == "timed_suggest"
    timer.log_summary()


def test_device_trace_writes_a_trace_and_refuses_the_link(tmp_path):
    import torch

    with device_trace(str(tmp_path / "tr")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    (name,) = os.listdir(tmp_path / "tr")
    trace = json.loads((tmp_path / "tr" / name).read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    with pytest.raises(NotImplementedError, match="Perfetto"):
        with device_trace(str(tmp_path / "no"), create_perfetto_link=True):
            pass


def test_scope_cli_output_is_the_reference_cli_output(tmp_path, capsys):
    """``metrics`` and ``trace`` against a live port server with a
    recorder armed, and ``flight`` on the port's flight file: the port's
    console prints what the reference's prints."""
    path = str(tmp_path / "f.wal")
    rec = FlightRecorder(path=path)
    svc = SuggestService(space(hp), max_batch=4, background=False, n_startup_jobs=2,
                         recorder=rec, device="cpu", **ALGO_KW)
    drive(svc, [svc.create_study("s0", seed=0)], 2)
    srv = serve_forever(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = str(srv.server_address[1])
    try:
        for args in (["metrics", "--port", port], ["metrics", "--port", port, "--json"],
                     ["trace", "--port", port, "--tail", "4"],
                     ["trace", "--port", port, "--json"]):
            assert t_cli.main(args) == 0
            mine = capsys.readouterr().out
            assert j_cli.main(args) == 0
            assert mine == capsys.readouterr().out, args
            assert mine.strip()
    finally:
        srv.shutdown()
        srv.server_close()
        svc.shutdown()
    for args in (["flight", path, "--tail", "3"], ["flight", path, "--json"]):
        assert t_cli.main(args) == 0
        mine = capsys.readouterr().out
        assert j_cli.main(args) == 0
        assert mine == capsys.readouterr().out, args
    lines = mine  # the --json read: every span of the two rounds
    assert len(json.loads(lines)) == len(rec.tail())
    jpath = str(tmp_path / "j.wal")
    jrec = JFlightRecorder(path=jpath)
    for i in range(5):
        jrec.record("e", tid=i)
    jrec.close()
    assert t_cli.main(["flight", jpath, "--tail", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 3 and "tid=4" in out[-1]
