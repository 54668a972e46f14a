"""Scene I/O: a minimal Wavefront OBJ loader and image writers (counterpart
of `blink.scene.io`). Host-side numpy; no dependency beyond it.
"""
from __future__ import annotations

import numpy as np
import torch

from blink_torch.scene.scene import Triangles


def load_obj(path: str, material_id: int = 0) -> Triangles:
    """Parse the v/vt/f records of a Wavefront OBJ into Triangles on the
    host.

    Supports 'v x y z', 'vt u v', 'f a b c ...' (fans triangulated),
    'f a/at b/bt c/ct', 'f a/at/an ...' and negative indices. A vertex takes
    its uv from the first vt it is seen with."""
    verts: list[list[float]] = []
    uvs: list[list[float]] = []
    vert_uv: dict[int, int] = {}
    faces: list[list[int]] = []

    def resolve(tok: str) -> tuple[int, int | None]:
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(verts) + vi
        ti = None
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(uvs) + t
        return vi, ti

    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if tok[0] == "v" and len(tok) >= 4:
                verts.append([float(tok[1]), float(tok[2]), float(tok[3])])
            elif tok[0] == "vt" and len(tok) >= 3:
                uvs.append([float(tok[1]), float(tok[2])])
            elif tok[0] == "f" and len(tok) >= 4:
                ids = []
                for t in tok[1:]:
                    vi, ti = resolve(t)
                    if ti is not None and vi not in vert_uv:
                        vert_uv[vi] = ti
                    ids.append(vi)
                for k in range(1, len(ids) - 1):  # fan triangulation
                    faces.append([ids[0], ids[k], ids[k + 1]])

    v = np.asarray(verts, np.float32).reshape(-1, 3)
    f = np.asarray(faces, np.int32).reshape(-1, 3)
    uv = np.zeros((v.shape[0], 2), np.float32)
    if uvs:
        uv_arr = np.asarray(uvs, np.float32).reshape(-1, 2)
        for vi, ti in vert_uv.items():
            if 0 <= ti < uv_arr.shape[0]:
                uv[vi] = uv_arr[ti]
    return Triangles(
        verts=torch.from_numpy(v),
        idx=torch.from_numpy(f),
        uv=torch.from_numpy(uv),
        material_id=torch.full((f.shape[0],), material_id, dtype=torch.int32),
    )


def _host(image) -> np.ndarray:
    if torch.is_tensor(image):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def save_image_npy(path: str, image) -> None:
    np.save(path, _host(image))


def save_image_ppm(path: str, image, gamma: float = 2.2) -> None:
    """Write a binary PPM (tonemapped) for eyeballing renders."""
    img = np.clip(_host(image), 0.0, 1.0) ** (1.0 / gamma)
    img8 = (img * 255.0 + 0.5).astype(np.uint8)
    h, w = img8.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(img8.tobytes())
