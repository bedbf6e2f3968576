"""Loading BENCHMARK.json and the files it names, by name."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
BENCHMARK = ROOT / "BENCHMARK.json"
METRICS = PKG / "metrics"
PROBLEMS = PKG / "problems"
DRIVERS = PKG / "drivers"

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load_benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def _load(kind: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    return json.loads((PKG / kind / f"{name}.json").read_text())


def load_config(name: str) -> dict:
    return _load("configs", name)


def load_traffic(name: str) -> dict:
    return _load("traffic", name)


def load_limits(cell: str) -> dict:
    return _load("limits", cell)


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    without tracing, the per-layer ones with it."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [e for e in entries if cell in e.get("workloads", (cell,))]


def _module(kind: str, name: str, directory: Path):
    """The module ``<directory>/<name>.py``, executed anew as
    ``portbench.<kind>.<name>``."""
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = Path(directory) / f"{name}.py"
    full = f"portbench.{kind}.{name}"
    spec = importlib.util.spec_from_file_location(full, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[full] = module
    spec.loader.exec_module(module)
    return module


def load_metric(name: str, directory: Path = METRICS):
    """The reader module ``<directory>/<name>.py``; its ``read(ctx)``
    returns the metric's value, or None where it finds nothing to read."""
    return _module("metrics", name, directory)


def load_problem(name: str, directory: Path = PROBLEMS):
    """The problem class ``<directory>/<name>.py``: its generator, how each
    driver hands its programs to the port, and its check (problems/
    dense_sdp.py says what a class holds)."""
    return _module("problems", name, directory)


def problem_of(config: dict, directory: Path = PROBLEMS):
    """The class that a configuration names under ``"class"``; there is no
    default."""
    if "class" not in config:
        raise ValueError(f"the configuration {config.get('source', config)!r} names no "
                         "problem class: give it a 'class' key (a file problems/<class>.py)")
    return load_problem(config["class"], directory)


def load_driver(name: str, directory: Path = DRIVERS):
    """The driver module ``<directory>/<name>.py``; its ``Driver`` is how a
    traffic mix whose ``driver`` key names it drives the port."""
    return _module("drivers", name, directory)
