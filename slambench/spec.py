"""Finds what `BENCHMARK.json` names: a cell's configuration, traffic,
limits and metric readers, each in a file of its own under `slambench/`,
by name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `end_to_end` or `per_layer` entries that `cell` reports: those
    that list it under `workloads`, or list no cells."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def load_cell(bench: dict, cell: str, root: Path = ROOT) -> dict:
    """Everything one cell needs, found by name: its workload entry, its
    configuration (the file `configs` names), its traffic
    (`traffic/<mix>.json`), its limits (`cells/<cell>.json`) and its
    metrics with their readers."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / HERE.name
    return dict(
        workload=w,
        config=_json(root / conf["file"]),
        traffic=_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=_json(here / "cells" / f"{cell}.json")["limits"],
        end_to_end=[(m, reader(m["name"], here))
                    for m in cell_metrics(bench, cell, "end_to_end")],
        per_layer=[(m, reader(m["name"], here)) for m in cell_metrics(bench, cell, "per_layer")],
    )


def reader(name: str, here: Path = HERE):
    """The module `metrics/<name>.py` under `here`, whose `read(record)`
    gives the metric or None."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
