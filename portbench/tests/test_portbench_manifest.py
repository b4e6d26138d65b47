"""BENCHMARK.json against the rules of its format, and every file it names."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}
CELLS = {w["name"]: w for w in M["workloads"]}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits into 43200 s
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(M).encode()) <= 64 * 1024
    assert all(_text_ok(w) and not w.startswith("/") and ".." not in w for w in M["command"])


def test_configs():
    assert 1 <= len(M["configs"]) <= 24
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _text_ok(c["source"]) and _text_ok(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert c["reduced"] == []
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_workloads():
    assert 1 <= len(M["workloads"]) <= 24 and len(CELLS) == len(M["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(M["workloads"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _text_ok(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
        assert all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def test_end_to_end():
    assert 1 <= len(E2E) <= 16 and "setup_s" in E2E
    assert E2E["setup_s"]["bound"] == 0.25 and "workloads" not in E2E["setup_s"]
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in ("host_clock",
                                                                      "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert all(c in CELLS for c in m.get("workloads", []))
    for cell in CELLS:
        reported = [m for m in M["end_to_end"] if _reports(m, cell)]
        assert len(reported) >= 2, cell


def test_per_layer():
    assert 1 <= len(M["per_layer"]) <= 128
    names = [m["name"] for m in M["per_layer"]] + list(E2E) + list(CELLS) + \
        [c["name"] for c in M["configs"]]
    for m in M["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _text_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert _reports(E2E[m["moves"]], cell), (m["name"], cell)
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in M["per_layer"]), cell
    assert len(set(n for n in names if n in {m["name"] for m in M["per_layer"]})) == \
        len(M["per_layer"])
    # a layer's metrics name it letter for letter
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers <= {"serve/engine", "pipeline/fused", "train/step", "preprocess/cleaner",
                      "kernels", "device"}


@pytest.mark.parametrize("path", sorted(p for p in BENCH.rglob("*") if p.is_file()
                                        and "__pycache__" not in p.parts),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_file_names(path):
    rel = path.relative_to(ROOT).as_posix()
    assert len(rel) <= 200 and re.match(r"^[A-Za-z0-9_./-]+$", rel)
