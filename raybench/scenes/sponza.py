"""The Sponza-class hall (`raybench/lib/scenes.py::sponza`): floor, walls,
one area light and pillars of stacked icospheres, checker-textured."""
from raybench.lib.scenes import sponza as build

#: The CPU tests' size.
TINY_ARGS = {"n_tris": 12_000, "seed": 7}
