"""What every cell of the benchmark shares: finding a cell's files by name,
the window arithmetic, the comparison against limits, and the result line.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration and a
traffic mix. Each lives in a file of its own, found by name:

  configs/<config>.json   the deployment: sizes, source, what is assumed
  traffic/<traffic>.json  the mix; its ``kind`` names the generator and
                          runner that read it, ``kinds/<kind>.py``
  limits/<cell>.json      the limit of each number the cell compares
  metrics/<metric>.py     one reader per metric: ``read(ctx)`` returns the
                          metric's value, or None where it finds nothing

so a later change adds a configuration, a mix, a cell or a metric as new
files and entries, and edits no file that is here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package the port was made from (compared whole, so the port,
# whose name starts with the JAX package's, does not match)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "mloam_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(cell: dict, pkg: Path = PKG) -> tuple[dict, dict, dict]:
    """(configuration, traffic mix, limits) of a cell, read by name."""
    conf = load_json(pkg / "configs" / f"{cell['config']}.json")
    traffic = load_json(pkg / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(pkg / "limits" / f"{cell['name']}.json")
    return conf, traffic, limits


def kind_module(traffic: dict, pkg: Path = PKG):
    """The runner of a traffic mix's ``kind``: ``kinds/<kind>.py``."""
    return _load_file(pkg / "kinds" / f"{traffic['kind']}.py", f"portbench_kind_{traffic['kind']}")


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, pkg: Path = PKG):
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read``."""
    return _load_file(pkg / "metrics" / f"{name}.py",
                      "portbench_metric_" + name.replace(".", "_").replace("-", "_")).read


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    (``--trace 0``) or its per-layer metrics (``--trace 1``). A metric with
    a ``workloads`` list belongs to those cells; one without it, to every
    cell (an end-to-end metric) or to every cell that reports the metric it
    moves (a per-layer metric)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metrics(specs: list[dict], ctx: dict, pkg: Path = PKG) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something; a reader that returns None leaves its metric out."""
    out = {}
    for m in specs:
        v = metric_reader(m["name"], pkg)(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


# ---------------------------------------------------------------------------
# window arithmetic
# ---------------------------------------------------------------------------

def ms_per_unit(units: int, seconds: float) -> float | None:
    return seconds * 1e3 / units if units > 0 and seconds > 0 else None


# ---------------------------------------------------------------------------
# correctness and the result line
# ---------------------------------------------------------------------------

def check(checks: dict, name: str, value: float, limits: dict):
    """Record the number ``name`` beside its limit (a NaN never passes)."""
    checks[name] = {"value": float(value), "limit": float(limits[name])}


def passed(checks: dict) -> bool:
    """Every number within its limit (a NaN compares false: it fails)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def loaded_forbidden(modules=None) -> list[str]:
    """Forbidden top-level names among ``modules`` (default: the loaded
    ones, ``sys.modules``), each compared whole, before its first dot."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None = None) -> str:
    """The contract's last line: ``checks``, each number compared with its
    limit, comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
