"""Finds a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names every configuration,
workload and metric. Each has a file of its own under ``benchmark/``,
found by its name alone:

* a configuration: the ``file`` its entry gives (``configs/<name>.json``);
* a traffic mix: ``workloads/<traffic>.json``, whose ``driver`` names the
  mining entry the window drives, ``drivers/<driver>.py``;
* a metric, end to end or per layer: ``metrics/<name>.py``, a reader with
  ``read(run) -> float | None``.

Adding a cell, a configuration or a metric is adding files and entries;
no file here names one. A name the JSON does not hold, or whose file is
missing, is refused (``SpecError``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


class SpecError(ValueError):
    """A name that BENCHMARK.json does not hold, or a file it names that
    is missing or malformed."""


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload entry with everything it names, loaded."""
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's file, ``driver`` included
    end_to_end: list      # the end-to-end metric entries this cell reports
    per_layer: list       # the per-layer metric entries this cell reports
    here: pathlib.Path = HERE   # the folder its files were found in


def _check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{what} name {name!r} is not a valid name")
    return name


def _read_json(path: pathlib.Path, what: str) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{what}: {path} is missing") from None
    except json.JSONDecodeError as e:
        raise SpecError(f"{what}: {path} is not JSON ({e})") from None


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return _read_json(root / "BENCHMARK.json", "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    names = metric.get("workloads")
    return names is None or workload in names


def cell(workload: str, spec: dict | None = None,
         root: pathlib.Path = ROOT, here: pathlib.Path = HERE) -> Cell:
    """The cell named ``workload``, with its configuration, its traffic
    mix and its metrics, each found by name."""
    spec = load_spec(root) if spec is None else spec
    _check_name(workload, "workload")
    entry = next((w for w in spec.get("workloads", ())
                  if w.get("name") == workload), None)
    if entry is None:
        raise SpecError(f"no workload named {workload!r} in BENCHMARK.json")
    config_name = _check_name(entry["config"], "config")
    conf = next((c for c in spec.get("configs", ())
                 if c.get("name") == config_name), None)
    if conf is None:
        raise SpecError(f"workload {workload!r} names config "
                        f"{config_name!r}, which BENCHMARK.json lacks")
    config = _read_json(root / conf["file"], f"config {config_name}")
    traffic_name = _check_name(entry["traffic"], "traffic")
    traffic = _read_json(here / "workloads" / f"{traffic_name}.json",
                         f"traffic {traffic_name}")
    if "driver" not in traffic:
        raise SpecError(f"traffic {traffic_name!r} names no driver")
    driver_file(traffic["driver"], here)
    e2e = [m for m in spec.get("end_to_end", ()) if _applies(m, workload)]
    layers = [m for m in spec.get("per_layer", ()) if _applies(m, workload)]
    for m in e2e + layers:
        metric_file(m["name"], here)
    return Cell(workload, int(entry["chips"]), config, traffic, e2e, layers,
                here)


def _file(kind: str, name: str, here: pathlib.Path) -> pathlib.Path:
    path = here / kind / f"{_check_name(name, kind)}.py"
    if not path.is_file():
        raise SpecError(f"no {kind} file for {name!r} ({path})")
    return path


def driver_file(name: str, here: pathlib.Path = HERE) -> pathlib.Path:
    return _file("drivers", name, here)


def metric_file(name: str, here: pathlib.Path = HERE) -> pathlib.Path:
    return _file("metrics", name, here)


def load_module(path: pathlib.Path):
    """Imports the file ``path`` as a module of its own (its name may hold
    ``-`` or ``.``), once per process."""
    key = "benchmark._files." + re.sub(r"[^A-Za-z0-9_]", "_", str(path))
    module = sys.modules.get(key)
    if module is None:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return module
