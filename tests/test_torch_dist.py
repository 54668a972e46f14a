"""blink_torch.dist on gloo ranks against single-process rendering and blink.

The ranks are processes spawned with torch.multiprocessing, one spawn per
world size, meeting on a FileStore in the test's tmp_path (no TCP port to
pick). They import torch and blink_torch only; the parent, which imports
blink, builds the inputs, loads what each rank saved and compares
(mirroring tests/test_dist.py):
  - scene-sharded chunk traversal at 4 ranks (3000 triangles,
    chunk_tris=500: 6 real and 2 empty chunks, 2 per rank) equals the
    replicated chunked traversal exactly, and blink's closest hits;
  - scene-sharded brute force equals brute force on the reordered scene
    (the port's brute, which test_torch_sphere.py holds to blink's), and
    the reordering equals blink's;
  - dist_render at 2 and 4 ranks equals render bit for bit (Cornell 32x32,
    deterministic, brute);
  - dist_render_grad matches render_grad and blink's jax.grad;
  - (test_torch_dryrun.py) the same two calls on another configuration,
    given to the ranks in inputs.pt;
  - a height that does not divide by the world size raises.
In process: a one-rank group (render --dist 1, dist_fit_step), and
init_distributed without torchrun's variables.
"""
import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from blink_torch.api import build_scene, render, render_grad
from blink_torch.config import get_config
from blink_torch.dist import mesh
from blink_torch.dist.render import dist_fit_step, dist_render, dist_render_grad
from blink_torch.dist.scene_shard import (
    build_sharded_chunks,
    intersect_chunks_sharded,
    intersect_scene_sharded,
    occluded_chunks_sharded,
    occluded_scene_sharded,
    shard_scene_triangles,
)
from blink_torch.kernels.bruteforce import intersect_brute, occluded_brute
from blink_torch.kernels.traverse_packed import (
    build_chunked_packed,
    traverse_anyhit_packed,
    traverse_closest_packed,
)
from blink_torch.scene.scene import Triangles, make_scene

CFG = get_config("cornell").override(width=32, height=32, deterministic=True,
                                     backend="brute")
NAMES = ("albedo", "emission")


def _tris(verts, idx) -> Triangles:
    return Triangles(verts=verts, idx=idx, uv=torch.zeros((verts.shape[0], 2)),
                     material_id=torch.zeros((idx.shape[0],), dtype=torch.int32))


def _rank_main(rank: int, world: int, path: str) -> None:
    """One rank: run every distributed function on the saved inputs and
    save what it returns to rank<r>.pt. The inputs may name another
    configuration to render, as "config": (preset, overrides), with its
    "names" and "target"; CFG, NAMES and a zero image otherwise."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(path, "store"), world),
                            rank=rank, world_size=world)
    try:
        inp = torch.load(os.path.join(path, "inputs.pt"))
        out = {}
        if world == 4:
            tris = _tris(inp["verts"], inp["idx"])
            chunks, meta = build_sharded_chunks(tris, 4, chunk_tris=500)
            out["n_chunks"], out["per_shard"] = len(chunks), meta.per_shard
            out["t"], out["prim"] = intersect_chunks_sharded(inp["o"], inp["d"], chunks, meta)
            out["blocked"] = occluded_chunks_sharded(inp["o"], inp["d"], chunks, meta,
                                                     inp["t_far"])
            scene = shard_scene_triangles(
                make_scene(triangles=_tris(inp["verts_b"], inp["idx_b"])), 4)
            out["idx_sharded"] = scene.triangles.idx
            hit = intersect_scene_sharded(inp["o_b"], inp["d_b"], scene)
            out["hit_t"], out["hit_kind"], out["hit_prim"] = hit.t, hit.kind, hit.prim
            out["occ"] = occluded_scene_sharded(inp["o_b"], inp["d_b"], scene, inp["t_far_b"])
            try:
                uneven = CFG.override(height=30)
                dist_render(build_scene(uneven), uneven, device="cpu")
            except ValueError as e:
                out["uneven"] = str(e)
        cfg, names, target = CFG, NAMES, torch.zeros(32, 32, 3)
        if "config" in inp:
            preset, overrides = inp["config"]
            cfg = get_config(preset).override(**overrides)
            names, target = tuple(inp["names"]), inp["target"]
        scene = build_scene(cfg)
        out["image"] = dist_render(scene, cfg, device="cpu")
        out["loss"], g = dist_render_grad(scene, cfg, target, names, device="cpu")
        out.update({f"g_{k}": v for k, v in g.items()})
        torch.save(out, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(world: int, path, inputs: dict, timeout: float = 300.0) -> list[dict]:
    torch.save(inputs, os.path.join(path, "inputs.pt"))
    ctx = mp.start_processes(_rank_main, args=(world, str(path)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
    return [torch.load(os.path.join(path, f"rank{r}.pt")) for r in range(world)]


def _as_t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _assert_ranks_agree(outs, keys):
    for k in keys:
        for o in outs[1:]:
            assert torch.equal(o[k], outs[0][k]), k


@functools.cache
def _reference_grads():
    """blink's loss and jax.grad of NAMES on CFG's scene, once per module."""
    from blink.api import build_scene as jax_build_scene
    from blink.api import render_grad as jax_render_grad
    from blink.config import get_config as jax_get_config

    jcfg = jax_get_config("cornell").override(width=32, height=32, deterministic=True)
    loss, g = jax_render_grad(jax_build_scene(jcfg), jcfg, np.zeros((32, 32, 3), np.float32),
                              param_names=NAMES)
    return float(loss), {n: np.asarray(v) for n, v in g.items()}


def _check_render_and_grads(outs, world):
    """Image bit for bit; gradients against the single-process port (sums
    in another order: blink's own tolerance for this, tests/test_dist.py)
    and against blink's jax.grad (test_torch_grads.py's tolerances)."""
    from test_torch_grads import GRAD_TOL

    _assert_ranks_agree(outs, ["image", "loss"] + [f"g_{k}" for k in NAMES])
    scene = build_scene(CFG)
    img = render(scene, CFG, device="cpu")
    assert torch.equal(outs[0]["image"], img), world
    target = torch.zeros(32, 32, 3)
    loss, g = render_grad(scene, CFG, target, NAMES, device="cpu")
    torch.testing.assert_close(outs[0]["loss"], loss, rtol=1e-6, atol=0)
    ref_loss, ref = _reference_grads()
    np.testing.assert_allclose(outs[0]["loss"].item(), ref_loss, rtol=1e-5)
    for n in NAMES:
        got = outs[0][f"g_{n}"]
        torch.testing.assert_close(got, g[n], rtol=1e-4, atol=1e-6)
        rtol, atol = GRAD_TOL[n]
        np.testing.assert_allclose(got.numpy(), ref[n], rtol=rtol, atol=atol, err_msg=n)


def test_four_ranks_match_replicated_and_reference(tmp_path):
    from blink.dist.scene_shard import shard_scene_triangles as jax_shard_scene_triangles
    from blink.scene.scene import make_scene as jax_make_scene
    from test_bvh import _random_rays, _random_tris
    from test_torch_binary_walks import _reference

    tris, tris_b = _random_tris(3000, 31), _random_tris(500, 21)  # 511 nodes: one ref shape
    o, d = _random_rays(300, 32)
    o_b, d_b = _random_rays(256, 22)
    t_far = np.full((300,), 5.0, np.float32)
    t_far[::3] = 0.0
    inputs = {
        "verts": _as_t(tris.verts), "idx": _as_t(tris.idx, torch.int32),
        "o": _as_t(o), "d": _as_t(d), "t_far": _as_t(t_far),
        "verts_b": _as_t(tris_b.verts), "idx_b": _as_t(tris_b.idx, torch.int32),
        "o_b": _as_t(o_b), "d_b": _as_t(d_b), "t_far_b": torch.full((256,), 5.0),
    }
    outs = _spawn(4, tmp_path, inputs)
    _assert_ranks_agree(outs, ["t", "prim", "blocked", "hit_t", "hit_kind", "hit_prim", "occ"])
    r0 = outs[0]
    assert r0["n_chunks"] == 8 and r0["per_shard"] == 2

    # Sharded chunks == the replicated chunked traversal, exactly, and
    # blink's closest hits and occlusion (random triangles: no ties).
    port_tris = _tris(inputs["verts"], inputs["idx"])
    chunks = build_chunked_packed(port_tris, chunk_tris=500)
    assert len(chunks) == 6
    t_rep, p_rep = traverse_closest_packed(inputs["o"], inputs["d"], chunks)
    assert torch.equal(r0["t"], t_rep) and torch.equal(r0["prim"], p_rep)
    assert torch.equal(r0["blocked"],
                       traverse_anyhit_packed(inputs["o"], inputs["d"], chunks, inputs["t_far"]))
    t_ref, p_ref, b_ref = _reference(tris, o, d, t_far)
    np.testing.assert_array_equal(r0["prim"].numpy(), p_ref)
    np.testing.assert_allclose(r0["t"].numpy(), t_ref, rtol=1e-6, atol=1e-6)
    assert 0 < b_ref.sum()
    np.testing.assert_array_equal(r0["blocked"].numpy(), b_ref)

    # Scene-sharded brute force == brute force on the same reordered scene.
    ref_scene = jax_shard_scene_triangles(jax_make_scene(triangles=tris_b), 4)
    np.testing.assert_array_equal(r0["idx_sharded"].numpy(), np.asarray(ref_scene.triangles.idx))
    sharded = shard_scene_triangles(make_scene(triangles=_tris(inputs["verts_b"], inputs["idx_b"])), 4)
    hp = intersect_brute(inputs["o_b"], inputs["d_b"], sharded)
    assert (hp.prim > 0).sum() > 10
    for k in ("t", "kind", "prim"):
        assert torch.equal(r0[f"hit_{k}"], getattr(hp, k)), k
    occ = occluded_brute(inputs["o_b"], inputs["d_b"], sharded, inputs["t_far_b"])
    assert 0 < occ.sum() and torch.equal(r0["occ"], occ)

    assert all("must divide by mesh size 4" in o["uneven"] for o in outs)
    _check_render_and_grads(outs, 4)


def test_two_ranks_render_and_grads(tmp_path):
    _check_render_and_grads(_spawn(2, tmp_path, {}), 2)


def test_single_rank_group_and_torchrun_env(monkeypatch, tmp_path):
    """Without torchrun's variables init_distributed returns False and
    opens nothing; render --dist 1 opens and closes a one-rank group in
    process and writes the image that render does; --dist 2 without
    torchrun raises."""
    from blink_torch.cli import main

    for k in mesh.ENV:
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_distributed() is False and not dist.is_initialized()
    args = ["render", "--config", "cornell", "--width", "16", "--height", "16",
            "--deterministic", "--device", "cpu"]
    main(args + ["--dist", "1", "--out", str(tmp_path / "d.npy")])
    assert not dist.is_initialized()
    main(args + ["--out", str(tmp_path / "s.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "d.npy"), np.load(tmp_path / "s.npy"))
    with pytest.raises(ValueError, match="torchrun"):
        main(args + ["--dist", "2"])
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="incomplete"):
        mesh.init_distributed()


def test_dist_fit_step_on_one_rank():
    """One Adam step of dist_fit_step in a one-rank group equals the same
    step on render_grad's gradient."""
    scene = build_scene(CFG)
    target = torch.zeros(32, 32, 3)
    mesh.init_single_rank("gloo")
    try:
        params = {"albedo": scene.materials.albedo.clone().requires_grad_(True)}
        opt = torch.optim.Adam(list(params.values()), lr=1e-2)
        loss = dist_fit_step(scene, CFG, target, opt, params, device="cpu")
    finally:
        mesh.close()
    ref = {"albedo": scene.materials.albedo.clone().requires_grad_(True)}
    ref_opt = torch.optim.Adam(list(ref.values()), lr=1e-2)
    ref_loss, g = render_grad(scene, CFG, target, ("albedo",), device="cpu")
    ref["albedo"].grad = g["albedo"]
    ref_opt.step()
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=0)
    torch.testing.assert_close(params["albedo"].detach(), ref["albedo"].detach(),
                               rtol=1e-6, atol=1e-7)
    assert not torch.equal(params["albedo"].detach(), scene.materials.albedo)
