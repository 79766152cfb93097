"""What a cell is made of, read from ``BENCHMARK.json`` and the files that
the names in it lead to."""

from __future__ import annotations

import importlib
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(kind: str, name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def module(package: str, name: str):
    """``vrbench.<package>.<name>``: a chain's costs, an entry, a metric's
    reader (module names take ``_`` for the ``.`` and ``-`` of a name)."""
    leaf = _name(package, name).replace(".", "_").replace("-", "_")
    return importlib.import_module(f"vrbench.{package}.{leaf}")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Path = BENCHMARK) -> Cell:
    spec = load_json(bench)
    entry = next((w for w in spec["workloads"]
                  if w["name"] == _name("workload", name)), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {bench.name}")
    config = _name("config", entry["config"])
    traffic = _name("traffic", entry["traffic"])
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(HERE / "configs" / f"{config}.json"),
                traffic=load_json(HERE / "traffic" / f"{traffic}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])
