"""blink_torch's config-5 dry run and the path integrator's gradients over
gloo ranks on the CPU.

- dryrun_step(2): one sharded training step (path integrator, bvh,
  gradients of albedo and tri_verts all-reduced, an Adam step) and the
  scene-sharded walk, over 2 ranks it spawns itself.
- On the same tiny `pod` configuration, dist_render at 2 ranks (run by
  test_torch_dist.py's rank runner) equals a one-process render bit for
  bit, and dist_render_grad's gradients of albedo and tri_verts equal a
  one-process render_grad's within rtol 1e-6 and an atol of 1e-6 of the
  largest |g|: only the order of the sums over pixels and ranks differs.
"""
import numpy as np
import torch

from blink_torch.api import build_scene, render, render_grad
from blink_torch.config import get_config
from blink_torch.dist.render import dryrun_step

NAMES = ("albedo", "tri_verts")
#: Beside rtol 1e-6, an atol of this share of the largest |g|: a vertex
#: gradient summed from terms of both signs can end near 0, where one
#: rounding of a term moves it by more than 1e-6 of itself (measured: 6.0e-7
#: of the largest |g| for tri_verts, 1.7e-7 for albedo).
GRAD_ATOL_SHARE = 1e-6
OVERRIDES = dict(width=16, height=16, spp=1, max_depth=2, sponza_tris=2_000,
                 deterministic=True, backend="bvh")
CFG = get_config("pod").override(**OVERRIDES)


def _target() -> torch.Tensor:
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.uniform(0.0, 0.5, (16, 16, 3)).astype(np.float32))


def test_dryrun_step_two_ranks():
    dryrun_step(2)


def test_dist_path_grad_matches_single_process(tmp_path):
    from test_torch_dist import _spawn

    outs = _spawn(2, tmp_path, {"config": ("pod", OVERRIDES), "names": list(NAMES),
                                "target": _target()})
    scene = build_scene(CFG)
    img = render(scene, CFG, device="cpu")
    loss, g = render_grad(scene, CFG, _target(), NAMES, device="cpu")
    assert img.max() > 0.01
    for o in outs:
        assert torch.equal(o["image"], img)
        np.testing.assert_allclose(o["loss"].item(), loss.item(), rtol=1e-6)
        for k in NAMES:
            scale = g[k].abs().max().item()
            assert scale > 0, k
            np.testing.assert_allclose(o[f"g_{k}"].numpy(), g[k].numpy(), rtol=1e-6,
                                       atol=GRAD_ATOL_SHARE * scale, err_msg=k)
