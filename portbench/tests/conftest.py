"""Shared fixtures of the benchmark's CPU tests: a copy of the harness's data
files at a size the CPU can run (``small_tree``), and the ``card`` marker
for the tests that need the GPU (each decides inside itself and skips)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SMALL_GRAPH = {"n_poses": 300, "n_loops": 12}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


def make_small_tree(tmp: Path) -> tuple[Path, Path]:
    """(package dir, checkout root) of a copy of ``portbench``'s data files
    and of ``BENCHMARK.json``, with every pose graph cut to
    ``SMALL_GRAPH``, for runs on the CPU."""
    from portbench import harness

    pkg = tmp / "portbench"
    shutil.copytree(harness.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for p in (pkg / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        if d.get("kind") == "pose_graph":
            d.update(SMALL_GRAPH)
            p.write_text(json.dumps(d))
    return pkg, tmp


@pytest.fixture
def small_tree(tmp_path):
    return make_small_tree(tmp_path)
