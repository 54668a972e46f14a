"""The reference of a configuration whose scene brings an `instances`
group (objects, obj_of_inst, o2w; raybench/scenes/sponza_tlas.py): the
group is flattened to world triangles here, in float64 with numpy and
nothing of the program, and held to the scene's `triangles`; then the
frame or the step is rendered by `render.py` from those arrays, whose
traversal is its own over the world triangles. So the comparison that
decides `correct` holds the program's two-level walk to a flat one."""
from __future__ import annotations

import numpy as np

from raybench.reference import render

#: The largest gap allowed between a flattened corner and the scene's, in
#: world units: the scene rounds each corner to float32 once or twice (at
#: the hall's 40 units an ulp is 3.8e-6), so a few ulps; an instance placed
#: wrongly is off by its size (0.4 or more).
FLATTEN_TOL = 1e-4


def flatten(instances: dict) -> np.ndarray:
    """(T, 3, 3) float64 world corners of every instance's triangles, in
    instance order."""
    obj = instances["objects"]
    verts = np.asarray(obj["verts"], np.float64)
    idx = np.asarray(obj["idx"], np.int64)
    start = np.asarray(obj.get("tri_start", [0, idx.shape[0]]), np.int64)
    o2w = np.asarray(instances["o2w"], np.float64)
    out = []
    for m, b in zip(o2w, np.asarray(instances["obj_of_inst"], np.int64)):
        corners = verts[idx[start[b]:start[b + 1]]]  # (t, 3, 3)
        out.append(corners @ m[:, :3].T + m[:, 3])
    return np.concatenate(out)


def check(arrays: dict) -> float:
    """The largest gap between the flattened instances and `triangles`;
    raises above FLATTEN_TOL or where the counts differ."""
    t = arrays["triangles"]
    want = np.asarray(t["verts"], np.float64)[np.asarray(t["idx"], np.int64)]
    got = flatten(arrays["instances"])
    if got.shape != want.shape:
        raise ValueError(f"instances flatten to {got.shape[0]} triangles, the scene has "
                         f"{want.shape[0]}")
    gap = float(np.abs(got - want).max())
    if not gap <= FLATTEN_TOL:
        raise ValueError(f"instances flatten {gap} from the scene's triangles "
                         f"(limit {FLATTEN_TOL})")
    return gap


def loss_and_grads(arrays, *args, **kwargs):
    check(arrays)
    return render.loss_and_grads(arrays, *args, **kwargs)


def frame_pixels(arrays, *args, **kwargs):
    check(arrays)
    return render.frame_pixels(arrays, *args, **kwargs)
