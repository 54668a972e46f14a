"""blink_torch's binary BVH builds against blink, array for array.

- Host builds: `build_flat_bvh` (Morton, leaf 16) and `build_sah_bvh` at
  leaf 16 equal blink's arrays exactly, config 2's bunny included; the
  packed child metadata (rchild, axis, lower_first) equals lanes 9-11 of
  blink's `pack_bvh_planes` rows; a tree too deep for STACK_CAP raises
  blink's error.

The walks over these builds are test_torch_binary_walks.py's; the shared
helpers (`_np`, `_rays`, `_t_far`) live here.
"""
import numpy as np
import pytest
import torch

from blink.bvh import build_flat_bvh as jax_build_flat_bvh
from blink.bvh.sah import build_sah_bvh as jax_build_sah_bvh
from blink.kernels.traverse_pallas import pack_bvh_planes as jax_pack_bvh_planes
from blink.scene import builders as jax_builders
from blink_torch.bvh.build import build_flat_bvh
from blink_torch.bvh.sah import build_sah_bvh
from blink_torch.bvh.types import FlatBVH
from blink_torch.kernels import traverse_packed as tp
from blink_torch.scene import builders
from test_bvh import _random_rays, _random_tris

N_RAYS = 300
FIELDS = ("lo", "hi", "skip", "first", "count", "tv0", "te1", "te2", "tri_id")


def _np(tris):
    return np.asarray(tris.verts), np.asarray(tris.idx)


def _rays(seed):
    o, d = _random_rays(N_RAYS, seed)
    return o, d, torch.from_numpy(np.array(o)), torch.from_numpy(np.array(d))


def _t_far():
    """t_far 5 on most rays, 0 on every third: those find nothing."""
    tf = np.full((N_RAYS,), 5.0, np.float32)
    tf[::3] = 0.0
    return tf


def _assert_flat_equal(ref, port) -> None:
    for f in FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert port.leaf_size == ref.leaf_size


@pytest.mark.parametrize("ntri, seed", [(0, 0), (64, 3), (700, 5), (3000, 7)])
def test_flat_and_sah_leaf16_match_reference(ntri, seed):
    tris = _random_tris(ntri, seed)
    _assert_flat_equal(jax_build_flat_bvh(tris), build_flat_bvh(*_np(tris)))
    if ntri:
        _assert_flat_equal(jax_build_sah_bvh(tris, 16), build_sah_bvh(*_np(tris), 16))


def test_flat_bvh_of_config2_bunny():
    """Config 2's bunny (subdiv 6): the arrays equal blink's; 81,924
    triangles in 16,383 nodes and 131,072 slots."""
    ref = jax_builders.bunny_scene(6).triangles
    port = builders.bunny_scene(6).triangles
    verts, idx = port.verts.numpy(), port.idx.numpy()
    np.testing.assert_array_equal(verts, np.asarray(ref.verts))
    np.testing.assert_array_equal(idx, np.asarray(ref.idx))
    bvh = build_flat_bvh(verts, idx)
    assert idx.shape[0] == 81_924 and bvh.n_nodes == 16_383 and bvh.tri_id.shape[0] == 131_072
    _assert_flat_equal(jax_build_flat_bvh(ref), bvh)


@pytest.mark.parametrize("builder", ["flat", "sah"])
def test_packed_metadata_matches_reference_lanes(builder):
    tris = _random_tris(3000, 7)
    if builder == "flat":
        ref, port = jax_build_flat_bvh(tris), build_flat_bvh(*_np(tris))
    else:
        ref, port = jax_build_sah_bvh(tris, 16), build_sah_bvh(*_np(tris), 16)
    rec = np.asarray(jax_pack_bvh_planes(ref).nrow).reshape(-1, 16)[: port.n_nodes]
    pk = tp.pack_bvh_planes(port)
    assert pk.n_nodes == port.n_nodes and (pk.rchild.numpy() > 0).any()
    for lane, got in ((6, pk.skip), (7, pk.node[:, tp.FIRST]), (8, pk.node[:, tp.COUNT]),
                      (9, pk.rchild), (10, pk.axis), (11, pk.lower_first)):
        np.testing.assert_array_equal(got.numpy(), rec[:, lane].astype(np.int32), err_msg=lane)
    np.testing.assert_array_equal(pk.box[:, 0:3].numpy(), rec[:, 0:3])
    np.testing.assert_array_equal(pk.box[:, 4:7].numpy(), rec[:, 3:6])


def test_too_deep_tree_raises():
    """A chain nested 69 deep needs a stack of 71 > STACK_CAP = 64."""
    n = 70
    box = np.zeros((n, 3), np.float32)
    chain = FlatBVH(
        lo=box, hi=box + 1, skip=np.full(n, n, np.int32), first=np.zeros(n, np.int32),
        count=np.zeros(n, np.int32), tv0=np.zeros((4, 3), np.float32),
        te1=np.zeros((4, 3), np.float32), te2=np.zeros((4, 3), np.float32),
        tri_id=np.full(4, -1, np.int32),
    )
    with pytest.raises(ValueError, match="BVH depth 69 needs stack 71 > STACK_CAP=64"):
        tp.pack_bvh_planes(chain)
    tp.pack_bvh_planes(FlatBVH(**{**chain.__dict__, "skip": np.arange(1, n + 1, dtype=np.int32)}))
