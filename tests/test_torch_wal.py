"""The port's write-ahead log (``hyperopt_tpu_torch.utils.wal.TellWAL``),
the rstate cursor codec and the history ``.npz`` against the reference's.

Both packages write the same bytes for the same records (header and all,
for the same guard), truncate a torn tail to the same prefix, refuse a
mid-file checksum failure, and read each other's logs; the cursor codec
round-trips the same JSON; a history buffer's ``.npz`` bytes load into an
equal buffer in either package.
"""

import json
import os

import numpy as np
import pytest

from hyperopt_tpu.exceptions import CheckpointError as JCheckpointError
from hyperopt_tpu.utils import checkpoint as JC
from hyperopt_tpu.utils.wal import WAL_MAGIC as J_MAGIC
from hyperopt_tpu.utils.wal import TellWAL as JWAL
from hyperopt_tpu_torch import hp as thp
from hyperopt_tpu_torch.exceptions import CheckpointError
from hyperopt_tpu_torch.ops.compile import compile_space
from hyperopt_tpu_torch.torch_trials import ObsBuffer
from hyperopt_tpu_torch.utils import checkpoint as TC
from hyperopt_tpu_torch.utils.wal import WAL_MAGIC, TellWAL

GUARD = ["graftserve", 1, "tpe", "fingerprint"]


def _records(rng):
    """Record bodies of every kind both logs write, with numpy-made
    values (an ask's cursor, served vals, a tell's result dict)."""
    gen = np.random.default_rng(int(rng.integers(1 << 30)))
    gen.integers(2**31 - 1)
    out = [("open", {"seed": 3}, True)]
    for tid in range(6):
        vals = {"x": float(rng.uniform(-5, 5)), "c": int(rng.integers(3))}
        out.append(("ask", {"tid": tid, "seed": int(rng.integers(2**31 - 1)),
                            "rstate": JC.encode_rstate(gen)}, False))
        out.append(("served", {"tid": tid, "vals": vals}, False))
        if tid == 4:
            out.append(("fail", {"tid": tid, "doc": {"state": 3, "misc": {"tid": tid}}}, True))
        else:
            out.append(("tell", {"tid": tid, "vals": vals, "loss": float(rng.normal()),
                                 "result": {"status": "ok", "loss": float(rng.normal()),
                                            "extra": [1, "a"]}}, tid % 2 == 0))
    return out


def _write_both(tmp_path, rng, guard=GUARD):
    paths = str(tmp_path / "j.wal"), str(tmp_path / "t.wal")
    jw, tw = JWAL(paths[0], guard=guard), TellWAL(paths[1], guard=guard)
    for kind, body, sync in _records(rng):
        assert jw.append(kind, body, sync=sync) == tw.append(kind, body, sync=sync)
    jw.barrier(), tw.barrier()
    jw.close(), tw.close()
    return paths


def test_records_are_byte_equal_to_the_reference(tmp_path):
    """Same bodies, same guard: the two files are the same bytes, header
    included, and each package replays the other's file to the same
    records and counters."""
    jpath, tpath = _write_both(tmp_path, np.random.default_rng(0))
    assert WAL_MAGIC == J_MAGIC
    jb, tb = open(jpath, "rb").read(), open(tpath, "rb").read()
    assert jb == tb and jb.count(b"\n") == 1 + 1 + 6 * 3
    jrec, trec = JWAL(tpath, guard=GUARD).replay(), TellWAL(jpath, guard=GUARD).replay()
    assert jrec == trec and [r["seq"] for r in trec] == list(range(19))
    a, b = JWAL(jpath), TellWAL(tpath)
    assert (a.total_tells, a.next_seq) == (b.total_tells, b.next_seq) == (5, 19)


def test_append_scan_reset_counters_match(tmp_path):
    """Compaction keeps the monotone counters in both, and the compacted
    files are byte-equal too."""
    jpath, tpath = _write_both(tmp_path, np.random.default_rng(1))
    jw, tw = JWAL(jpath, guard=GUARD), TellWAL(tpath, guard=GUARD)
    jw.reset(), tw.reset()
    assert jw.replay() == tw.replay() == []
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    body = {"tid": 6, "vals": {"x": 0.5}, "loss": 1.25}
    assert jw.append("tell", body) == tw.append("tell", body) == 19
    assert jw.total_tells == tw.total_tells == 6
    header, recs, good, torn = TellWAL(tpath).scan()
    assert header["base_seq"] == 19 and header["base_tells"] == 5
    assert [r["tid"] for r in recs] == [6] and torn == 0 and good == os.path.getsize(tpath)


@pytest.mark.parametrize("tail", [b'deadbeef {"seq": 99, "kind": "tell", "tid": 7',
                                  b"\xff\xfe\x00garbage"])
def test_torn_tail_truncated_identically(tmp_path, tail):
    jpath, tpath = _write_both(tmp_path, np.random.default_rng(2))
    size = os.path.getsize(tpath)
    for p in (jpath, tpath):
        with open(p, "ab") as f:
            f.write(tail)
    jr, tr = JWAL(jpath).replay(), TellWAL(tpath).replay()
    assert jr == tr and len(tr) == 19
    assert os.path.getsize(jpath) == os.path.getsize(tpath) == size
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    # appends continue from the valid prefix
    assert TellWAL(tpath).append("tell", {"tid": 9, "vals": {}, "loss": 0.0}) == 19


def test_midfile_checksum_failure_raises(tmp_path):
    jpath, tpath = _write_both(tmp_path, np.random.default_rng(3))
    for p in (jpath, tpath):
        lines = open(p).read().splitlines(keepends=True)
        lines[2] = "00000000 " + lines[2].split(" ", 1)[1]
        with open(p, "w") as f:
            f.write("".join(lines))
    with pytest.raises(JCheckpointError, match="not a torn tail"):
        JWAL(jpath).replay()
    with pytest.raises(CheckpointError, match="not a torn tail"):
        TellWAL(tpath).replay()


def test_guard_mismatch_refused(tmp_path):
    _jpath, tpath = _write_both(tmp_path, np.random.default_rng(4))
    with pytest.raises(CheckpointError, match="different study"):
        TellWAL(tpath, guard=["another"]).replay()
    assert len(TellWAL(tpath).replay()) == 19  # no guard, no opinion


def test_group_commit_barrier_counts_fsyncs(tmp_path):
    """Flush-only appends are visible at once and one barrier covers them
    all; a second barrier is a no-op."""
    wal = TellWAL(str(tmp_path / "g.wal"))
    for tid in range(4):
        wal.append("tell", {"tid": tid, "vals": {}, "loss": 0.0}, sync=False)
    assert wal.fsyncs == 1  # the header's publish
    assert len(TellWAL(wal.path).replay()) == 4
    assert wal.barrier() is True and wal.barrier() is False
    assert wal.fsyncs == 2


@pytest.mark.parametrize("make", [lambda: np.random.default_rng(123),
                                  lambda: np.random.RandomState(7)])
def test_rstate_codec_round_trips_as_the_reference(make):
    a, b = make(), make()
    for g in (a, b):
        (g.integers if hasattr(g, "integers") else g.randint)(2**31 - 1)
    enc = TC.encode_rstate(a)
    assert json.loads(json.dumps(enc)) == json.loads(json.dumps(JC.encode_rstate(b)))
    draw = (lambda g: int(g.integers(2**31 - 1))) if hasattr(a, "integers") else (
        lambda g: int(g.randint(2**31 - 1)))
    want = [draw(a) for _ in range(5)]
    cursor = json.loads(json.dumps(enc))
    t, j = TC.decode_rstate(cursor), JC.decode_rstate(cursor)
    assert [draw(t) for _ in range(5)] == [draw(j) for _ in range(5)] == want


def _space(hp):
    return {"x": hp.uniform("x", -5, 5), "lr": hp.loguniform("lr", -5, 0),
            "arch": hp.choice("arch", [{"w": hp.quniform("w", 1, 9, 1)}, {"d": hp.randint("d", 4)}])}


def test_obs_buffer_npz_loads_into_an_equal_buffer():
    """The port's ``.npz`` bytes load into an equal buffer in both
    packages, and the reference's into the port's; a buffer of another
    space is refused; the loaded arrays are copies."""
    from hyperopt_tpu import hp as jhp
    from hyperopt_tpu.jax_trials import ObsBuffer as JObsBuffer
    from hyperopt_tpu.ops.compile import compile_space as jcompile

    tps, jps = compile_space(_space(thp), device="cpu"), jcompile(_space(jhp))
    assert list(tps.labels) == list(jps.labels)
    rng = np.random.default_rng(5)
    tb, jb = ObsBuffer(tps), JObsBuffer(jps)
    for tid in rng.permutation(150):  # late inserts and one growth
        vals = {"x": float(rng.uniform(-5, 5)), "lr": float(np.exp(rng.uniform(-5, 0)))}
        vals.update({"arch": 0, "w": float(rng.integers(1, 10))} if tid % 3
                    else {"arch": 1, "d": int(rng.integers(4))})
        loss = float(rng.normal())
        tb.add(vals, loss, tid=int(tid))
        jb.add(vals, loss, tid=int(tid))
    names = ("values", "active", "losses", "valid", "tids")
    blob = TC.obs_buffer_npz_bytes(tb)
    for loaded in (TC.load_obs_buffer_bytes(tps, blob), JC.load_obs_buffer_bytes(jps, blob),
                   TC.load_obs_buffer_bytes(tps, JC.obs_buffer_npz_bytes(jb))):
        assert (loaded.count, loaded.capacity) == (tb.count, tb.capacity) == (150, 512)
        for name in names:
            assert np.array_equal(getattr(loaded, name), getattr(tb, name)), name
    mine = TC.load_obs_buffer_bytes(tps, blob)
    mine.values[:] = 0  # a copy: the source buffer is untouched
    assert np.abs(tb.values).sum() > 0
    other = compile_space({"y": thp.uniform("y", 0, 1)}, device="cpu")
    with pytest.raises(ValueError, match="labels"):
        TC.load_obs_buffer_bytes(other, blob)


def test_obs_buffer_file_pair_and_orbax_refusal(tmp_path):
    ps = compile_space(_space(thp), device="cpu")
    buf = ObsBuffer(ps)
    buf.add({"x": 1.0, "lr": 0.1, "arch": 1, "d": 2}, 0.5, tid=0)
    path = str(tmp_path / "buf.npz")
    TC.save_obs_buffer(buf, path)
    back = TC.load_obs_buffer(ps, path)
    assert back.count == 1 and np.array_equal(back.values, buf.values)
    with pytest.raises(NotImplementedError, match="Orbax"):
        TC.save_obs_buffer_orbax(buf, str(tmp_path / "o"))
    with pytest.raises(NotImplementedError, match="Orbax"):
        TC.load_obs_buffer_orbax(ps, str(tmp_path / "o"))
