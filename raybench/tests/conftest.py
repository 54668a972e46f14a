"""Puts the checkout root (for `raybench`) and `src` (for the program) on
the path, gives the tests small cells to run on the CPU, and runs every
test that takes a `cell` once for each one-card cell of `BENCHMARK.json`."""
import copy
import dataclasses
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: The image side the CPU tests cut each cell to.
_TINY_SIDE = 32


def pytest_generate_tests(metafunc):
    """`cell`: each cell of the manifest that asks for one card (the tests
    run one process)."""
    if "cell" in metafunc.fixturenames:
        manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
        metafunc.parametrize("cell", [w["name"] for w in manifest["workloads"]
                                      if w["chips"] == 1])


def tiny(spec):
    """A copy of CellSpec `spec` cut to a CPU test's size: its scene file's
    `TINY_ARGS` and a 32x32 image (the bunny's `bunny_subdiv` follows)."""
    config = copy.deepcopy(spec.config)
    config["scene_args"] = dict(spec.scene.TINY_ARGS)
    if "bunny_subdiv" in config.get("render", {}):
        config["render"]["bunny_subdiv"] = config["scene_args"]["subdiv"]
    traffic = copy.deepcopy(spec.traffic)
    traffic["render"].update(width=_TINY_SIDE, height=_TINY_SIDE)
    if "target" in traffic:
        traffic["target"]["cells"] = 8
    traffic["warmup_steps"] = 1
    if "pixels" in traffic["check"]:
        traffic["check"]["pixels"] = 256
    return dataclasses.replace(spec, config=config, traffic=traffic, limits=dict(spec.limits))


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def tiny_cell(root):
    """tiny() of a cell of the manifest at `at` (the checkout by default)."""
    from raybench.lib.bench import cell_spec

    return lambda name, at=root, manifest=None: tiny(cell_spec(at, name, manifest))
