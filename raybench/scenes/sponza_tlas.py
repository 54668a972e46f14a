"""Config 4 as published: the Sponza-class hall of `sponza.py`
(`raybench/lib/scenes.py::sponza`, its arrays untouched) with its
two-level form beside it, the `instances` group that the program's `tlas`
backend walks (blink_torch.scene.scene.instances_from_numpy):

  objects: verts (V, 3) f32 and idx (T, 3) i32 of 7 objects end to end, in
           object space, tri_start (8,) i32: object 0 the hall shell (its 10
           triangles, floor, walls and light, as the scene has them),
           objects 1-6 a unit icosphere of 1,280 triangles, one a column
           material;
  obj_of_inst (I,) i32, o2w (I, 3, 4) f32: instance 0 the shell (the
           identity), then one an orb, its radius and centre from the same
           draws of the same generator, in the same order, as `sponza`.

Instance i's triangles are the scene's triangles [tri_offset[i], +count),
tri_offset the running sum in instance order, so the flattened instances
are `triangles` (raybench/reference/instanced.py holds them to it)."""
import numpy as np

from raybench.lib.scenes import F32, I32, icosphere, sponza

#: The CPU tests' size.
TINY_ARGS = {"n_tris": 12_000, "seed": 7}

#: Triangles of the hall shell, the first of the scene's.
SHELL_TRIS = 10
N_COL_MATS = 6


def build(n_tris: int = 1_000_000, seed: int = 7) -> dict:
    arrays = sponza(n_tris, seed)
    tris = arrays["triangles"]
    shell_idx = tris["idx"][:SHELL_TRIS]
    shell_v = tris["verts"][: int(shell_idx.max()) + 1]
    unit_v, unit_f, _ = icosphere(3)

    # sponza's draws: the column materials' albedos, then per pillar its
    # jitter, per orb its radius and material.
    rng = np.random.default_rng(seed)
    for _ in range(N_COL_MATS):
        rng.random(3)
    hx, hz = 20.0, 40.0
    n_orbs = max(1, (n_tris - SHELL_TRIS) // (20 * 4**3))
    stack_h = 4
    n_pillars = max(1, n_orbs // stack_h)
    gx = int(np.ceil(np.sqrt(n_pillars / 2)))
    gz = int(np.ceil(n_pillars / max(gx, 1)))
    obj_of_inst = [0]
    o2w = [np.concatenate([np.eye(3, dtype=F32), np.zeros((3, 1), F32)], axis=1)]
    placed = 0
    for pz in range(gz):
        for px in range(gx):
            if placed >= n_orbs:
                break
            x = -hx * 0.8 + (1.6 * hx * 0.8) * (px + 0.5) / gx
            z = -hz * 0.9 + (1.8 * hz * 0.9) * (pz + 0.5) / gz
            jx, jz = 0.25 * rng.standard_normal(2)
            for s in range(stack_h):
                if placed >= n_orbs:
                    break
                r = 0.5 - 0.06 * s + 0.05 * rng.random()
                m = np.zeros((3, 4), F32)
                m[:, :3] = np.float32(r) * np.eye(3, dtype=F32)
                m[:, 3] = np.asarray((x + jx, 0.5 + 1.0 * s, z + jz), F32)
                obj_of_inst.append(1 + int(rng.integers(N_COL_MATS)))
                o2w.append(m)
                placed += 1

    verts = [shell_v] + [unit_v] * N_COL_MATS
    starts = np.cumsum([0] + [len(v) for v in verts])
    idx = [shell_idx] + [unit_f + starts[1 + b] for b in range(N_COL_MATS)]
    arrays["instances"] = {
        "objects": {"verts": np.concatenate(verts).astype(F32),
                    "idx": np.concatenate(idx).astype(I32),
                    "tri_start": np.cumsum([0] + [len(f) for f in idx]).astype(I32)},
        "obj_of_inst": np.asarray(obj_of_inst, I32),
        "o2w": np.stack(o2w).astype(F32),
    }
    return arrays
