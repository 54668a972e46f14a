"""Puts the checkout root (for `raybench`) and `src` (for the program) on
the path, and gives the tests small cells to run on the CPU."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: Scene sizes and image sides the CPU tests cut each cell to.
_TINY_SCENE = {"sponza": {"n_tris": 12_000, "seed": 7}, "bunny": {"subdiv": 3}}
_TINY_SIDE = 32


def tiny(spec):
    """A copy of CellSpec `spec` cut to a CPU test's size: a small scene
    and a 32x32 image (the bunny mesh 3 times subdivided)."""
    from raybench.lib.bench import CellSpec

    config = copy.deepcopy(spec.config)
    config["scene_args"] = dict(_TINY_SCENE[config["scene"]])
    if "bunny_subdiv" in config.get("render", {}):
        config["render"]["bunny_subdiv"] = config["scene_args"]["subdiv"]
    traffic = copy.deepcopy(spec.traffic)
    traffic["render"].update(width=_TINY_SIDE, height=_TINY_SIDE)
    if "target" in traffic:
        traffic["target"]["cells"] = 8
    traffic["warmup_steps"] = 1
    if "pixels" in traffic["check"]:
        traffic["check"]["pixels"] = 256
    return CellSpec(spec.root, spec.manifest, spec.workload, config, traffic,
                    dict(spec.limits))


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def tiny_cell(root):
    from raybench.lib.bench import cell_spec

    return lambda name: tiny(cell_spec(root, name))
