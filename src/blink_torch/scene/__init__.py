"""Scene representation, procedural builders and I/O."""
from blink_torch.scene.io import load_obj, save_image_npy, save_image_ppm
from blink_torch.scene.scene import (
    LIGHT_SPHERE,
    LIGHT_TRI,
    Camera,
    Lights,
    Materials,
    Scene,
    Spheres,
    Triangles,
    derive_lights,
    make_scene,
    triangle_area_normal,
    triangle_vertices,
)

__all__ = [
    "Camera", "Lights", "Materials", "Scene", "Spheres", "Triangles",
    "derive_lights", "make_scene", "triangle_area_normal", "triangle_vertices",
    "LIGHT_SPHERE", "LIGHT_TRI", "load_obj", "save_image_npy", "save_image_ppm",
]
