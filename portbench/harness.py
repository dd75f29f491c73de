"""What every run shares: finding a cell's files by name, the card check,
the check that no JAX module was loaded, the per-layer readers, and the
result line.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
and a traffic mix. The configuration's file is the one BENCHMARK.json's
`configs` gives; the mix is `traffic/<traffic>.json`; the mix names its
entry, `entries/<entry>.py`; each per-layer metric is read by
`metrics/<name>.py`. Adding a cell, a mix, an entry or a metric is adding
files: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_snark_aggregator_tpu")


class Refused(Exception):
    """A run that must print no result (no card, a JAX module loaded)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file `path` as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def module_name(prefix: str, name: str) -> str:
    return "portbench_" + prefix + "_" + "".join(
        c if c.isalnum() else "_" for c in name)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list     # BENCHMARK.json's metrics this cell reports
    per_layer: list

    @property
    def entry(self) -> str:
        return self.mix["entry"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, mix and metrics."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / cfgs[w["config"]]["file"])
    mix = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    layer = [m for m in spec["per_layer"] if _applies(m, name)]
    return Cell(name, int(w["chips"]), config, mix, e2e, layer)


def entry_module(cell: Cell, root: Path = ROOT):
    return load_module(root / "portbench" / "entries" / f"{cell.entry}.py",
                       module_name("entry", cell.entry))


def reader(metric: str, root: Path = ROOT):
    return load_module(root / "portbench" / "metrics" / f"{metric}.py",
                       module_name("metric", metric))


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is False: no card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"{torch.cuda.device_count()} card(s), the cell needs "
                      f"{chips}")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    its libraries' or the JAX package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Outcome:
    """What an entry hands back: the run's counts, the end-to-end values,
    what the per-layer readers read, the comparisons, the device."""

    attempted: int
    failed: int
    end_to_end: dict          # metric name -> value
    readings: dict            # entry, spans, counters, trace, shapes
    checks: dict              # short name -> (value, limit)
    device: dict
    breakdown: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)  # to stderr

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def per_layer_values(cell: Cell, readings: dict, root: Path = ROOT) -> dict:
    """Each per-layer metric's reader over the run's readings; a reader
    that finds nothing returns None and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"], root).read(readings)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result(cell: Cell, outcome: Outcome, trace: bool, root: Path = ROOT) -> dict:
    if trace:
        metrics = per_layer_values(cell, outcome.readings, root)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in outcome.end_to_end.items() if k in units}
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics,
           "device": outcome.device}
    if trace and outcome.breakdown:
        out["breakdown"] = outcome.breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in outcome.checks.items()}
    return out


def check_lines(outcome: Outcome) -> list[str]:
    """The run's notes, then every number compared beside its limit."""
    return ([f"note {k} {v}" for k, v in outcome.notes.items()]
            + [f"check {k} {v} limit {lim}"
               for k, (v, lim) in outcome.checks.items()])
