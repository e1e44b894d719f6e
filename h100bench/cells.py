"""The benchmark as data: a cell of ``BENCHMARK.json``'s ``workloads`` names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its limits on the numbers that decide
``correct`` are ``limits/<cell>.json``; each metric is read by
``metrics/<metric>.py``, or where that file is absent by
``metrics/<metric up to its first dot>.py`` (``idle_share.extract`` and
``idle_share.generate`` share ``metrics/idle_share.py``). Adding a cell,
configuration, mix or metric adds files and entries; no file changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list   # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list    # and with --trace 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: listed under its ``workloads``, or,
    without that key, every cell for an end-to-end metric and, for a
    per-layer one, every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load(name: str, bench: Path = ROOT / "BENCHMARK.json", here: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench``, its files read from ``here``."""
    spec = _json(bench)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {bench}: {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in spec["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=w["chips"],
                config=_json(here / "configs" / f"{w['config']}.json"),
                mix=_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=_json(here / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, here: Path = HERE):
    """The ``read(run, name)`` function of ``metric``'s file."""
    for stem in (metric, metric.split(".")[0]):
        path = here / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"h100bench_metric_{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under {here / 'metrics'}")
