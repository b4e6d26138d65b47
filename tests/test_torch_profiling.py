"""Port parity: the profiling tools (`utils/profiling.py`,
`tools/trace_summary.py`) and the stdout tee (`utils/logging.py`) against
the JAX package's, on the CPU."""

import gzip
import io
import json
import sys

import pytest
import torch

from cadx_tpu.tools import trace_summary as JTS
from cadx_tpu.utils import logging as JLog
from cadx_tpu.utils import profiling as JProf
from cadx_tpu_torch.tools import trace_summary as TTS
from cadx_tpu_torch.utils import logging as TLog
from cadx_tpu_torch.utils import profiling as TProf

# (name, microseconds) of the card's kernels in the written trace
KERNELS = [("conv_bf16_kernel<64>", 812), ("relax_sweeps<unsigned char>", 95),
           ("conv_bf16_kernel<64>", 790), ("pool_kernel<float, true>", 40),
           ("relax_sweeps<unsigned char>", 101), ("epilogue", 7)]


def _write_trace(path, kernels, launches):
    """A Chrome trace as torch.profiler writes it, gzipped: a host process
    with `launches` cudaLaunchKernel records and CPU ops, and a device
    process ("/device:GPU:0", the name JAX's reader keys on) with the
    kernel records."""
    events = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python3"}},
              {"ph": "M", "name": "process_name", "pid": 2, "args": {"name": "/device:GPU:0"}}]
    t = 0
    for i in range(launches):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1,
                       "tid": 1, "ts": t, "dur": 5})
        events.append({"ph": "X", "cat": "cpu_op", "name": f"aten::op{i}", "pid": 1, "tid": 1,
                       "ts": t, "dur": 20})
        t += 30
    for name, dur in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": name, "pid": 2, "tid": 7, "ts": t,
                       "dur": dur})
        t += dur
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_gives_jax_table(tmp_path):
    _write_trace(tmp_path / "w.trace.json.gz", KERNELS, len(KERNELS))
    got = TTS.summarize(str(tmp_path))
    assert got == JTS.summarize(str(tmp_path))
    rows, total = got
    assert rows[0] == ("conv_bf16_kernel<64>", 1.602, 2)
    assert total == pytest.approx(sum(d for _, d in KERNELS) / 1e3)
    assert TTS.summarize(str(tmp_path), top=2)[1] == total


def test_main_prints_jax_table_and_completeness(tmp_path, capsys):
    _write_trace(tmp_path / "w.trace.json.gz", KERNELS, len(KERNELS))
    assert JTS.main(["x", str(tmp_path)]) == 0
    jax_out = capsys.readouterr().out
    assert TTS.main(["x", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "\n".join(out[1:-1]) == "\n".join(jax_out.splitlines()[1:])
    assert out[-1].startswith("window complete: 6 kernel launches")


@pytest.mark.parametrize("gz", [True, False])
def test_incomplete_window(tmp_path, capsys, gz):
    """A trace holding fewer kernel records than launch calls (the card's
    records lost) reads "incomplete", gzipped or not."""
    path = tmp_path / ("w.trace.json.gz" if gz else "w.json")
    _write_trace(tmp_path / "tmp.gz", KERNELS[:4], len(KERNELS))
    if not gz:
        path.write_text(gzip.open(tmp_path / "tmp.gz", "rt").read())
        (tmp_path / "tmp.gz").unlink()
    else:
        (tmp_path / "tmp.gz").rename(path)
    c = TTS.completeness(TTS.load_events(str(tmp_path)))
    assert c == {"launches": 6, "kernels": 4, "complete": False}
    TTS.main(["x", str(tmp_path)])
    assert "window incomplete: 6 kernel launches on the host, 4 kernel records" in \
        capsys.readouterr().out


def test_trace_writes_what_summarize_reads(tmp_path):
    """trace() on the CPU: a Chrome trace under log_dir that summarize and
    completeness read (no card: no device records, a whole window)."""
    with TProf.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    paths = list(tmp_path.glob("*.json"))
    assert len(paths) == 1
    rows, total = TTS.summarize(str(tmp_path))
    assert rows == [] and total == 0.0
    assert TTS.completeness(TTS.load_events(str(paths[0])))["complete"]


def test_stage_timer_matches_jax():
    t, j = TProf.StageTimer(), JProf.StageTimer()
    for timer in (t, j):
        with timer.stage("a"):
            sum(range(1000))
        with timer.stage("a", sync_value=torch.zeros(3) if timer is t else None):
            pass
        with timer.stage("b"):
            pass
    assert set(t.times) == {"a", "b"} and all(v >= 0 for v in t.times.values())
    j.times = dict(t.times)
    assert t.report() == j.report()


def test_throughput_one_sync_at_the_end():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2
    rate, per_call = TProf.throughput(fn, torch.ones(4), iters=5, items_per_call=8)
    assert len(calls) == 6
    assert per_call > 0 and rate == pytest.approx(8 / per_call)


def test_logger_and_tee_match_jax(tmp_path, monkeypatch):
    outs = {}
    for name, mod in (("jax", JLog), ("torch", TLog)):
        term = io.StringIO()
        monkeypatch.setattr(sys, "stdout", term)
        path = tmp_path / f"{name}.txt"
        with mod.tee_stdout(str(path)) as logger:
            print("epoch 1 loss 0.5")
            print("done", end="")
            assert logger.isatty() == term.isatty()
        assert sys.stdout is term
        outs[name] = (term.getvalue(), path.read_text())
        buf, f = io.StringIO(), io.StringIO()
        lg = mod.Logger(buf, f)
        lg.write("x")
        lg.flush()
        assert buf.getvalue() == f.getvalue() == "x"
    assert outs["torch"] == outs["jax"] == ("epoch 1 loss 0.5\ndone",) * 2
