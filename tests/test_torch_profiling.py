"""Port parity: the profiling tools (`utils/profiling.py`,
`tools/trace_summary.py`) and the stdout tee (`utils/logging.py`) against
the JAX package's, on the CPU; the port's own spans and counters, on the
paths that open them and in the benchmark readers that read them."""

import gzip
import io
import json
import sys

import pytest
import torch

from cadx_tpu.tools import trace_summary as JTS
from cadx_tpu.utils import logging as JLog
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


# ---- the port's spans and counters ----------------------------------------

def _trace_json(prof, tmp_path) -> list:
    path = tmp_path / "spans.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_span_without_profiler_is_one_check(monkeypatch):
    """No profiler recording: `span` checks `_profiler_enabled` once, opens
    no `record_function`, returns one shared null context and keeps no
    stats; `count` adds to the totals alone."""
    checks, opened = [], []
    real_enabled, real_rf = torch.autograd._profiler_enabled, torch.profiler.record_function
    monkeypatch.setattr(torch.autograd, "_profiler_enabled",
                        lambda: checks.append(1) or real_enabled())
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: opened.append(a) or real_rf(*a, **k))
    TProf.reset()
    a, b = TProf.span("pipeline"), TProf.span("featurize")
    with a:
        TProf.count("host_syncs")
    assert a is b and len(checks) == 2 and not opened
    assert TProf.span_stats() == {} and TProf.counts() == {"host_syncs": 1}


def test_count_adds_to_every_open_span_and_the_totals():
    TProf.reset()
    TProf.count("x")
    TProf.host_sync(torch.device("cpu"), 5)          # not a card: not counted
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with TProf.span("outer"):
            TProf.count("x", 2)
            with TProf.span("inner"):
                TProf.count("x", 3)
                TProf.count("y")
    stats = TProf.span_stats()
    assert stats["outer"]["counts"] == {"x": 5, "y": 1}
    assert stats["inner"]["counts"] == {"x": 3, "y": 1}
    assert stats["outer"]["parents"] == {None} and stats["inner"]["parents"] == {"outer"}
    assert TProf.counts() == {"x": 6, "y": 1}
    TProf.reset()
    assert TProf.counts() == {} and TProf.span_stats() == {}


def _run_pipeline():
    from cadx_tpu_torch.pipeline import fused
    from cadx_tpu_torch.synthetic import synthetic_mammograms

    cfg = fused.PipelineConfig(image_hw=(64, 64))
    params = fused.init_pipeline_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(synthetic_mammograms(2, 64, seed=11))
    return lambda: fused.run_pipeline(params, x, cfg)


def _featurize():
    from cadx_tpu_torch.models import unet
    from cadx_tpu_torch.synthetic import synthetic_native_mammogram
    from cadx_tpu_torch.tools import train

    stem = unet.init_resnet_stem(torch.Generator().manual_seed(0))
    img = synthetic_native_mammogram(96, 80, seed=3)
    return lambda: train.featurize(stem, img, (8, 8), "cpu")


def _adam_step():
    from cadx_tpu_torch.models import cnn
    from cadx_tpu_torch.train import optim, step

    cfg = cnn.CNNConfig(input_shape=(10, 10, 3), num_classes=3, conv_layers=((6, 3),),
                        hidden_units=(8,), dropout_rate=0.0, conv_padding="SAME")
    model = cnn.init_params(torch.Generator().manual_seed(0), cfg)
    tx = optim.adam(1e-3)
    state = tx.init(model.parameters())
    g = torch.Generator().manual_seed(1)
    x = torch.rand((4, 10, 10, 3), generator=g)
    y = torch.nn.functional.one_hot(torch.tensor([0, 1, 2, 0]), 3).to(torch.float32)
    fn = step.make_adam_train_step(tx)
    return lambda: fn(model, state, x, y, torch.ones(4), None)


def _resnet_step():
    from cadx_tpu_torch.models import resnet
    from cadx_tpu_torch.train import classifier, optim

    cfg = resnet.ResNetConfig("bottleneck", (1, 1, 1, 1), (4, 8, 8, 16), 1, 2)
    model = resnet.init_resnet(torch.Generator().manual_seed(0), cfg)
    tx = optim.adam(1e-3)
    state = tx.init(model.parameters())
    x = torch.rand((2, 48, 40, 1), generator=torch.Generator().manual_seed(1))
    fn = classifier.make_resnet_train_step(tx)
    return lambda: fn(model, state, x, torch.tensor([0, 1]))


# path -> (its call, {span: parents})
SPAN_TREES = {
    "run_pipeline": (_run_pipeline, {
        "pipeline": {None}, "pipeline.clean": {"pipeline"}, "pipeline.encode": {"pipeline"},
        "pipeline.classify": {"pipeline"}, "pipeline.explain": {"pipeline"},
        "cleaner.front": {"pipeline.clean"}, "cleaner.pectoral": {"pipeline.clean"}}),
    "featurize": (_featurize, {
        "featurize": {None}, "featurize.upload": {"featurize"},
        "featurize.clean": {"featurize"}, "featurize.encode": {"featurize"},
        "featurize.fetch": {"featurize"}, "cleaner.front": {"featurize.clean"},
        "cleaner.pectoral": {"featurize.clean"}, "cleaner.resize": {"featurize.clean"}}),
    "adam_step": (_adam_step, {
        "train.step": {None}, "train.forward": {"train.step"},
        "train.backward": {"train.step"}, "train.optimizer": {"train.step"}}),
    "resnet_step": (_resnet_step, {
        "train.step": {None}, "train.forward": {"train.step"},
        "train.backward": {"train.step"}, "train.optimizer": {"train.step"},
        "resnet.stem": {"train.forward"}, "resnet.layer1": {"train.forward"},
        "resnet.layer2": {"train.forward"}, "resnet.layer3": {"train.forward"},
        "resnet.layer4": {"train.forward"}, "resnet.head": {"train.forward"}}),
}


@pytest.mark.parametrize("path", sorted(SPAN_TREES))
def test_spans_under_the_profiler(path, tmp_path):
    """A tiny call of each traced path under torch.profiler on the CPU
    records its spans with their parents, self time within total, and
    writes them to the Chrome trace as `cadx.*` ranges nested inside the
    caller's own range (the CPU counts no host syncs)."""
    make, tree = SPAN_TREES[path]
    call = make()
    TProf.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            call()
    stats = TProf.span_stats()
    assert {k: v["parents"] for k, v in stats.items()} == tree
    assert all(v["calls"] == 1 and 0 <= v["self_s"] <= v["total_s"] for v in stats.values())
    assert "host_syncs" not in TProf.counts()
    events = [e for e in _trace_json(prof, tmp_path)
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events}
    assert {n for n in ranges if n.startswith("cadx.")} == {"cadx." + k for k in tree}
    for name, parents in tree.items():
        outer = ranges["caller" if parents == {None} else "cadx." + next(iter(parents))]
        inner = ranges["cadx." + name]
        assert outer[0] <= inner[0] and inner[1] <= outer[1], name
    TProf.reset()


@pytest.mark.parametrize("routed", [False, True])
def test_resnet_step_counts_its_training_batch_norms(routed, monkeypatch):
    """`bn_train_kernel` inside `train.step`: each of the net's 17 batch
    norms once at its forward's launch (in `train.forward`) and once for
    its backward's (in `train.backward`, counted on the caller's thread
    after autograd returns): 106 for ResNet-50's 53; a forward that records
    no backward once each; none on the CPU's plain path."""
    from cadx_tpu_torch.kernels import batchnorm

    if routed:   # the card's launches, simulated over the plain versions
        plain_fwd, plain_bwd = batchnorm.batchnorm_train_forward, batchnorm.batchnorm_train_backward

        def forward(*args, **kw):
            out = plain_fwd(*args, **kw)
            forward.launches += 1
            TProf.count("bn_train_kernel")
            return out

        def backward(*args, **kw):
            out = plain_bwd(*args, **kw)
            backward.launches += 1
            return out

        forward.launches = backward.launches = 0
        monkeypatch.setattr(batchnorm, "batchnorm_train_forward", forward)
        monkeypatch.setattr(batchnorm, "batchnorm_train_backward", backward)
    call = _resnet_step()
    TProf.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        call()
        with torch.no_grad():    # a forward that records no backward: once each
            with TProf.span("probe"):
                from cadx_tpu_torch.models import resnet
                resnet.train_logits(resnet.init_resnet(
                    torch.Generator().manual_seed(2),
                    resnet.ResNetConfig("bottleneck", (1, 1, 1, 1), (4, 8, 8, 16), 1, 2)),
                    torch.rand((2, 48, 40, 1)))
    stats = TProf.span_stats()
    assert stats["train.step"]["counts"].get("bn_train_kernel", 0) == (34 if routed else 0)
    assert stats["train.forward"]["counts"].get("bn_train_kernel", 0) == (17 if routed else 0)
    assert stats["train.backward"]["counts"].get("bn_train_kernel", 0) == (17 if routed else 0)
    assert stats["probe"]["counts"].get("bn_train_kernel", 0) == (17 if routed else 0)
    TProf.reset()


@pytest.fixture(scope="module")
def tiny_checkout(tmp_path_factory):
    """The benchmark's CPU-sized cells (`portbench/tests/conftest.py`,
    which puts `portbench/` on the path while they run)."""
    import importlib.util
    from pathlib import Path

    saved = list(sys.path)
    path = Path(__file__).resolve().parents[1] / "portbench" / "tests" / "conftest.py"
    spec = importlib.util.spec_from_file_location("portbench_tiny_conftest", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod, mod.make_tiny_root(tmp_path_factory.mktemp("checkout"))
    sys.path[:] = saved


# tiny cell -> the program's span and counter metrics its traced run reads
PROGRAM_METRICS = {
    "basic-bulk-tiny": {"host_syncs.bulk"},
    "advanced-featurize-tiny": {"host_syncs.featurize", "featurize_upload_ms.featurize",
                                "pair_sweeps.featurize", "staged_uploads.featurize"},
    "advanced-train-tiny": set(),
}


@pytest.mark.parametrize("cell", sorted(PROGRAM_METRICS))
def test_benchmark_reads_program_spans(tiny_checkout, cell):
    """A traced run of a tiny cell on the CPU reads the port's spans and
    counters (no host syncs, no pair sweeps and no staged uploads there:
    0) and leaves `program_idle_ms.*` out, as the card's records are
    missing."""
    mod, root = tiny_checkout
    TProf.reset()
    r = mod.run_cell(root, cell, trace=1)
    assert r["correct"]
    got = {k: v["value"] for k, v in r["metrics"].items()
           if k.startswith(("host_syncs", "featurize_upload_ms", "pair_sweeps",
                            "staged_uploads", "program_idle_ms"))}
    assert set(got) == PROGRAM_METRICS[cell]
    assert all(v == 0 for k, v in got.items() if not k.startswith("featurize_upload_ms"))
    assert all(v > 0 for k, v in got.items() if k.startswith("featurize_upload_ms"))
    TProf.reset()


def test_trace_summary_prints_program_spans(tmp_path, capsys):
    """A trace holding `cadx.*` ranges: after the kernel table, each span's
    calls, host ms and self ms, and the card's idle ms by the innermost
    span open at each gap's middle."""
    def x(name, ts, dur, cat="user_annotation", tid=1):
        return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts,
                "dur": dur}

    events = [x("cadx.pipeline", 0, 1000), x("cadx.pipeline.clean", 100, 300),
              x("cadx.pipeline.encode", 500, 400), x("cadx.pipeline", 2000, 500),
              x("cadx.pipeline.clean", 2100, 100), x("portbench.enqueue", 0, 3000),
              x("k1", 0, 200, "kernel", 7), x("k2", 350, 650, "kernel", 7),
              x("k2", 2000, 100, "kernel", 7)]
    events += [x("cudaLaunchKernel", 0, 1, "cuda_runtime")] * 3
    (tmp_path / "w.json").write_text(json.dumps({"traceEvents": events}))
    assert TTS.program_spans(TTS.load_events(str(tmp_path))) == [
        ("cadx.pipeline", 2, 1.5, pytest.approx(0.7)), ("cadx.pipeline.clean", 2, 0.4, 0.4),
        ("cadx.pipeline.encode", 1, 0.4, 0.4)]
    # gaps: 200-350 (clean), 1000-2000 (none open), 2100-2500 (clean, then pipeline)
    assert TTS.idle_by_span(TTS.load_events(str(tmp_path))) == pytest.approx(
        {"cadx.pipeline.clean": 0.15, "no span": 1.0, "cadx.pipeline": 0.4})
    assert TTS.main(["x", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    i = next(k for k, line in enumerate(out) if line.startswith("window complete"))
    assert out[i + 1].split() == ["calls", "host", "ms", "self", "ms", "program", "span"]
    assert out[i + 2].split() == ["2", "1.500", "0.700", "cadx.pipeline"]
    assert out[i + 5].split()[-1] == "span"
    assert len(out) == i + 9
