"""The instanced hall's scene file and reference: its `instances` group
flattens to its `triangles`, which are sponza's; a misplaced instance is
refused; the two-level walk's counters read as its metrics."""
import numpy as np
import pytest

from raybench.lib import bench, scenes, tlaswork


@pytest.fixture
def hall(root):
    spec = bench.cell_spec(root, "sponza1m_tlas.path")
    return spec, spec.scene.build(**spec.scene.TINY_ARGS)


def test_instances_flatten_to_the_scene(hall):
    spec, arrays = hall
    inst = arrays["instances"]
    assert len(inst["obj_of_inst"]) == 9 and len(inst["objects"]["tri_start"]) == 8
    assert spec.reference.check(arrays) < 1e-5
    plain = scenes.sponza(**spec.scene.TINY_ARGS)
    for g in ("triangles", "materials", "lights", "camera"):
        for k, v in plain[g].items():
            np.testing.assert_array_equal(arrays[g][k], v)


def test_a_misplaced_instance_is_refused(hall):
    spec, arrays = hall
    o2w = arrays["instances"]["o2w"].copy()
    o2w[3, 1, 3] += 0.01
    bad = {**arrays, "instances": {**arrays["instances"], "o2w": o2w}}
    with pytest.raises(ValueError, match="from the scene's triangles"):
        spec.reference.check(bad)


def test_the_walk_counters_read_as_metrics():
    counts = {"tlas_pops.closest": 40, "tlas_pops.anyhit": 10, "blas_pops.closest": 30,
              "blas_pops.anyhit": 20, "tri_tests.closest": 300, "tri_tests.anyhit": 100,
              "blas_entries.closest": 20, "blas_entries.anyhit": 5, "walk_live.closest": 10,
              "walk_live.anyhit": 10, "walk_lanes.closest": 20}
    w = tlaswork.work(counts)
    assert w == {"tlas_pops": 50, "blas_pops": 50, "tri_tests": 400, "blas_entries": 25,
                 "walk_live": 20}
    s, by = tlaswork.bound_s(w)
    assert by == "operations" and s == pytest.approx((160 * 100 + 35 * 400 + 36 * 25) / 67e12)
    assert tlaswork.work({"walk_live.closest": 3}) is None
