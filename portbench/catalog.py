"""Finds the benchmark's parts by the names in BENCHMARK.json.

Every configuration, traffic mix, cell, metric and kernel count is a
file of its own, found by name, so that a new one is a new file:

- configs: the file that BENCHMARK.json names for the configuration;
- traffic/<traffic>.json: the mix's parameters, read by the generator
  traffic/<generator>.py that it names;
- workloads/<cell>.json: the cell's correctness limits and sample sizes;
- metrics/<metric>.py: a reader ``read(readings) -> float | None``;
- kernels/*.py: each kernel's count of work (``ROOFLINE``,
  ``DEVICE_KERNELS``, ``work(readings)``);
- entries/<entry>.py: the program's entry point that a configuration
  names (``open_entry(param, S, device)``);
- reference/<reference>.py: a configuration's plain reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def _json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(CHECKOUT / "BENCHMARK.json")


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(name: str) -> dict:
    return _named(benchmark()["workloads"], name, "workload")


def config(name: str) -> dict:
    entry = _named(benchmark()["configs"], name, "config")
    return _json(CHECKOUT / entry["file"])


def traffic(name: str) -> dict:
    return _json(HERE / "traffic" / f"{name}.json")


def workload(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def _load(path: Path, kind: str):
    mod_name = "portbench._" + kind + "_" + re.sub(r"\W", "_", path.stem)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def generator(name: str):
    return _load(HERE / "traffic" / f"{name}.py", "traffic")


def metric(name: str):
    return _load(HERE / "metrics" / f"{name}.py", "metric")


def kernels() -> list:
    return [_load(p, "kernel") for p in sorted((HERE / "kernels").glob(
        "*.py")) if p.name != "__init__.py"]


def entry(name: str):
    return _load(HERE / "entries" / f"{name}.py", "entry")


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def metrics_of(cell_name: str, trace: bool) -> list[dict]:
    """The metric entries a run of the cell reports: its end-to-end
    metrics, or with trace its per-layer ones."""
    b = benchmark()
    return [m for m in b["per_layer" if trace else "end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]
