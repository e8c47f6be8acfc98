"""BENCHMARK.json against the contract's shape, every cell's files found
by name, a cell added by files and entries alone, no JAX anywhere under
`slambench/`, and a run without a card."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from slambench import spec

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "orb_slam2_ssd_semantic_tpu"}


def bench():
    return spec.benchmark()


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "slambench/run.py"] and b["paths"] == ["slambench"]
    assert 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert all(w["chips"] == 1 for w in b["workloads"])
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in b[k]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert 0.0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_keys(kind):
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for e in bench()[kind]:
        assert set(e) <= allowed[kind], e
        assert NAME.match(e["name"]), e["name"]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for r in e.get("reduced", []):
            assert NAME.match(r)
        assert len(e.get("reduced", [])) <= 16


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_found_by_name(cell):
    b = bench()
    got = spec.load_cell(b, cell)
    assert got["traffic"]["mode"] in ("offline_jobs", "live_session")
    assert got["limits"] and got["config"]["slam"] and got["config"]["scene"]
    e2e = [m["name"] for m, _ in got["end_to_end"]]
    assert "setup_s" in e2e and len(e2e) >= 2 and got["per_layer"]
    for _, mod in got["end_to_end"] + got["per_layer"]:
        assert callable(mod.read)
    moves = {m["moves"] for m, _ in got["per_layer"]}
    assert moves <= set(e2e)


def test_roofline_and_shares_are_named_and_in_percent():
    for m in bench()["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of `slambench/` with a new configuration, traffic mix,
    metric and cell: new files, new entries, no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "slambench", root / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    conf = json.loads((ROOT / "slambench/configs/tum_static_loop.json").read_text())
    conf["name"] = "tum_static_slow"
    conf["scene"]["trajectory"]["laps"] = 1.0
    (root / "slambench/configs/tum_static_slow.json").write_text(json.dumps(conf))
    (root / "slambench/traffic/offline_burst.json").write_text(
        json.dumps({"mode": "offline_jobs", "warmup_jobs": 1, "realizations": 2}))
    (root / "slambench/cells/slow.offline.json").write_text(
        json.dumps({"limits": {"rigid_err_max": 1e-3}}))
    (root / "slambench/metrics/jobs_per_window.py").write_text(
        "def read(rec):\n    return len(rec.jobs) or None\n")
    b["configs"].append(dict(b["configs"][0], name="tum_static_slow",
                             file="slambench/configs/tum_static_slow.json"))
    b["workloads"].append({"name": "slow.offline", "config": "tum_static_slow",
                           "traffic": "offline_burst", "chips": 1, "why": "a slower circuit"})
    b["per_layer"].append({"name": "jobs_per_window", "unit": "jobs", "better": "higher",
                           "source": "host_clock", "layer": "whole sequence",
                           "moves": "offline_fps", "workloads": ["slow.offline"]})
    for m in b["end_to_end"]:
        if m["name"] == "offline_fps":
            m["workloads"].append("slow.offline")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    got = spec.load_cell(spec.benchmark(root), "slow.offline", root)
    assert got["config"]["scene"]["trajectory"]["laps"] == 1.0
    assert got["traffic"]["realizations"] == 2
    assert [m["name"] for m, _ in got["per_layer"]] == ["jobs_per_window"]
    assert {m["name"] for m, _ in got["end_to_end"]} == {"offline_fps", "setup_s"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "slambench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_reference_free_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.parts:
        # Plain numpy: nothing of the port, nor of the harness that drives it.
        assert tops <= {"__future__", "numpy"}, tops


def test_a_run_without_a_card_fails_and_prints_nothing(capsys, monkeypatch):
    import torch

    from slambench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "walking.live", "--seed", str(2**31 + 5), "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
