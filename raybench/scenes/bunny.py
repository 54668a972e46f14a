"""The bunny-class mesh (`raybench/lib/scenes.py::bunny`): a subdivided
icosphere over a floor under one area light."""
from raybench.lib.scenes import bunny as build

#: The CPU tests' size.
TINY_ARGS = {"subdiv": 3}
