"""Find a cell's files by name.

``BENCHMARK.json`` at the checkout's root lists the cells, configurations
and metrics; every other part lives in a file named after it:
``workloads/<cell>.json``, ``configs/<config>.json``, ``work/<config>.py``,
``metrics/<metric>.py``, ``targets/<target>.py`` and
``reference/<name>.py``.  Adding a cell, a configuration or a metric adds
files and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _entry(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str, base: Path = HERE) -> tuple:
    """(cell, config) of the workload ``name``: its traffic file and its
    configuration's file, checked against ``BENCHMARK.json``."""
    entry = _entry(bench["workloads"], name, "workload")
    spec = _json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {spec[key]!r} in its file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    _entry(bench["configs"], entry["config"], "config")
    config = _json(base / "configs" / f"{entry['config']}.json")
    return spec, config


def metrics(bench: dict, section: str, cell_name: str) -> list:
    """The ``section`` ("end_to_end" or "per_layer") metrics that cell
    ``cell_name`` reports: those without a ``workloads`` list, and those
    whose list names it."""
    return [m for m in bench[section]
            if cell_name in m.get("workloads", (cell_name,))]


def _module(path: Path, key: str):
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = HERE):
    """``read`` of ``metrics/<metric>.py``."""
    return _module(base / "metrics" / f"{metric}.py",
                   f"portbench_metric_{metric}").read


def work(config: str, base: Path = HERE):
    """The work model ``work/<config>.py``."""
    return _module(base / "work" / f"{config}.py", f"portbench_work_{config}")


def target(name: str):
    """``targets/<name>.py`` (arrays from the seed; the program's target)."""
    return importlib.import_module(f"portbench.targets.{name}")


def reference(name: str):
    """``reference/<name>.py``: a plain fitter or a target's plain score."""
    return importlib.import_module(f"portbench.reference.{name}")
