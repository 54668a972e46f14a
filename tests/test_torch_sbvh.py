"""blink_torch's SBVH builder (bvh.sbvh) and the spatial-split chunks of
build_chunked_wide against blink's, array for array, and the plain wide
walks over SBVH chunks against the object-split chunks, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blink.bvh.sbvh import build_sbvh as jax_build_sbvh
from blink.kernels.traverse_pallas import build_chunked_wide as jax_build_chunked_wide
from blink.scene.scene import Triangles as JaxTriangles
from blink_torch.bvh.sbvh import build_sbvh
from blink_torch.kernels import traverse_wide as tw
from test_bvh import _random_tris
from test_torch_build import port_tris
from test_torch_wide_modes import assert_tables_equal

FIELDS = ("lo", "hi", "skip", "first", "count", "tv0", "te1", "te2", "tri_id")


def _long_tris(n: int = 400, seed: int = 8) -> JaxTriangles:
    """Long thin triangles across a 20-unit box (floor planks, wall strips)
    beside small ones: the overlap that spatial splits cut."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    axis = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    length = np.where(np.arange(n) % 2 == 0, 16.0, 0.3).astype(np.float32)[:, None]
    v1 = base + axis * length
    v2 = base + 0.2 * rng.standard_normal((n, 3)).astype(np.float32)
    verts = np.concatenate([base, v1, v2])
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], -1).astype(np.int32)
    return JaxTriangles(verts=jnp.asarray(verts), idx=jnp.asarray(idx),
                        uv=jnp.zeros((3 * n, 2), jnp.float32),
                        material_id=jnp.zeros((n,), jnp.int32))


@pytest.mark.parametrize("name, tris", [("random3000", lambda: _random_tris(3000, 5)),
                                        ("long400", _long_tris)])
def test_build_sbvh_matches_reference(name, tris):
    tris = tris()
    ref = jax_build_sbvh(tris, 16)
    port = build_sbvh(np.asarray(tris.verts), np.asarray(tris.idx), 16)
    for f in FIELDS:
        got, want = getattr(port, f), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, f)
    assert port.leaf_size == 16 and port.heap2pre is None
    ids = port.tri_id[port.tri_id >= 0]
    # Spatial splits fired: references repeat, and every triangle is in.
    assert ids.size > np.unique(ids).size, name
    assert np.array_equal(np.unique(ids), np.arange(tris.idx.shape[0]))


@pytest.mark.parametrize("quant", [False, True])
def test_spatial_chunks_match_reference(quant):
    tris = _long_tris(900, 9)
    kw = dict(chunk_tris=400, quant=quant, row_tables=True, spatial=True)
    ref = jax_build_chunked_wide(tris, **kw)
    port = tw.build_chunked_wide(port_tris(tris), **kw)
    assert len(port) == 3
    assert_tables_equal(ref, port, quant, True)


@pytest.fixture(scope="module")
def walks():
    """The long triangles' SBVH and object-split chunks (quantized, no row
    tables, as the production backend) and 1024 rays from the box towards
    points near triangle centroids."""
    tris = port_tris(_long_tris(900, 9))
    kw = dict(chunk_tris=400, quant=True, row_tables=False)
    chunks = {s: [tw.WideChunk.from_host(c, "cpu")
                  for c in tw.build_chunked_wide(tris, spatial=s, **kw)]
              for s in (False, True)}
    rng = np.random.default_rng(12)
    v = tris.verts.numpy()[tris.idx.numpy()].mean(axis=1)
    aim = v[rng.integers(0, v.shape[0], 1024)] + 0.05 * rng.standard_normal((1024, 3))
    o = rng.uniform(-12, 12, (1024, 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return tris, chunks, f32(o), f32(d)


def test_sbvh_chunks_walk_like_object_chunks(walks):
    """The same closest hits (t equal; prim equal up to exact-t ties) and
    the same blocked flags with a finite t_far, on the plain walks."""
    _, chunks, o, d = walks
    t_s, p_s = tw.traverse_closest_wide(o, d, chunks[True])
    t_o, p_o = tw.traverse_closest_wide(o, d, chunks[False])
    assert (p_o >= 0).float().mean() > 0.3
    assert torch.equal(t_s, t_o)
    # With t equal everywhere, a prim that differs is an exact-t tie.
    assert (p_s == p_o).float().mean() > 0.99
    t_far = torch.where(p_o >= 0, t_o * 0.999, 8.0)
    b_s = tw.traverse_anyhit_wide(o, d, chunks[True], t_far)
    b_o = tw.traverse_anyhit_wide(o, d, chunks[False], t_far)
    assert torch.equal(b_s, b_o)


def test_sbvh_chunks_hold_duplicated_references(walks):
    """Unpadded, some triangle is in more than one leaf record of the SBVH
    chunks and none in the object-split ones; each holds every triangle."""
    tris = walks[0]
    for spatial, want in ((True, True), (False, False)):
        chunks = tw.build_chunked_wide(tris, chunk_tris=400, quant=True, row_tables=False,
                                       spatial=spatial, uniform=False)
        ids = np.concatenate([c.tri_id[c.tri_id >= 0] for c in chunks])
        assert np.array_equal(np.unique(ids), np.arange(tris.idx.shape[0])), spatial
        assert (ids.size > np.unique(ids).size) == want, spatial
