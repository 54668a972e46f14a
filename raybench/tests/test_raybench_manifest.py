"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name; a cell added with new files only."""
import json
import re
import shutil
import time

import pytest

from raybench.lib import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _manifest(root):
    return json.loads((root / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units(root):
    m = _manifest(root)
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert all(_line(w) for w in m["command"]) and len(m["command"]) <= 32
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for metric in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher") and metric["source"] in SOURCES
    for metric in m["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in m["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
        assert _line(metric["layer"])
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in m["workloads"]}) == len(m["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in m["workloads"]}
    assert len(pairs) == len(m["workloads"])
    assert len(json.dumps(m)) <= 64 * 1024


def test_cell_files_found_by_name(root, cell):
    spec = bench.cell_spec(root, cell)
    assert spec.traffic["kind"] in ("render_grad", "render")
    e2e = [m["name"] for m in spec.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.metrics(True)
    assert per_layer
    for m in spec.metrics(False) + per_layer:
        assert callable(bench.load_reader(root, m["name"]))
        if m in per_layer:
            assert m["moves"] in e2e
    assert set(spec.limits) >= {"loss_rel"} or set(spec.limits) == {"px_mean_rel", "px_off"}
    assert callable(spec.scene.build) and spec.scene.TINY_ARGS
    assert callable(spec.reference.loss_and_grads) and callable(spec.reference.frame_pixels)


def test_configs_and_metric_layers(root):
    m = _manifest(root)
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for c in m["configs"]:
        assert c["file"].startswith("raybench/") and (root / c["file"]).is_file()
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert set(x.get("workloads", [])) <= {w["name"] for w in m["workloads"]}


#: The dummy cells' traffic: each step kind under each integrator family.
_MIXES = {
    "grad_direct": ({"kind": "render_grad", "params": ["albedo"],
                     "target": {"cells": 4, "scale": 1.0}, "check": {"steps": 1}},
                    {"integrator": "direct"}, {"loss_rel": 1e-4, "grad_rel.albedo": 1e-4}),
    "grad_path": ({"kind": "render_grad", "params": ["albedo", "tri_verts"],
                   "target": {"cells": 4, "scale": 1.0}, "check": {"steps": 1}},
                  {"integrator": "path", "max_depth": 2},
                  {"loss_rel": 1e-4, "grad_rel.albedo": 1e-4, "grad_rel.tri_verts": 1e-4}),
    "frame_direct": ({"kind": "render", "check": {"steps": 1, "pixels": 64}},
                     {"integrator": "direct", "spp": 2}, {"px_mean_rel": 1e-4, "px_off": 0.0}),
}


@pytest.mark.parametrize("mix", sorted(_MIXES))
def test_a_cell_is_added_with_files_only(root, tmp_path, mix):
    """A new traffic mix, limits file, metric reader and manifest entries
    make a new cell that runs and compares correct, whatever its step kind
    and integrator: no existing file changes."""
    shutil.copytree(root / "raybench", tmp_path / "raybench")
    m = _manifest(root)
    traffic, render, limits = _MIXES[mix]
    name = f"sponza1m.{mix}_tiny"
    (tmp_path / "raybench" / "traffic" / f"{mix}_tiny.json").write_text(json.dumps({
        **traffic, "render": {"width": 16, "height": 16, "spp": 1, "deterministic": False,
                              **render},
        "warmup_steps": 1, "trace": {"skip_steps": 1, "steps": 1}}))
    (tmp_path / "raybench" / "limits" / f"{name}.json").write_text(json.dumps(limits))
    (tmp_path / "raybench" / "metrics" / "steps_in_window.py").write_text(
        "def read(ctx):\n    return len(ctx.step_s)\n")
    m["workloads"].append({"name": name, "config": "sponza1m", "traffic": f"{mix}_tiny",
                           "chips": 1, "why": "a dummy"})
    m["end_to_end"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                            "bound": 0.25, "source": "host_clock", "workloads": [name]})
    before = {f: f.read_bytes() for f in (tmp_path / "raybench").rglob("*") if f.is_file()}
    spec = bench.cell_spec(tmp_path, name, manifest=m)
    spec.config["scene_args"] = {"n_tris": 3000, "seed": 7}
    r = bench.run_cell(spec, 7, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"], r
    assert set(r["checks"]) == set(limits)
    assert r["metrics"]["steps_in_window"]["value"] == r["attempted"] >= 1
    assert {"setup_s", "steps_in_window"} <= set(r["metrics"])
    assert list(r)[-1] == "checks"
    assert all(f.read_bytes() == b for f, b in before.items())


#: A configuration's own scene: one small object placed several times by
#: `o2w`, flattened to world triangles, with the `instances` group beside.
_INSTANCED_SCENE = """
import numpy as np

from raybench.lib.scenes import MeshBuilder, assemble, camera, icosphere

TINY_ARGS = {"copies": 8, "subdiv": 2}


def build(copies=64, subdiv=3):
    v, f, uv = icosphere(subdiv)
    o2w = np.zeros((copies, 3, 4), np.float32)
    mb = MeshBuilder()
    mb.add_quad([-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4], 0)
    mb.add_quad([-1, 3.0, -1], [-1, 3.0, 1], [1, 3.0, 1], [1, 3.0, -1], 1)
    for i in range(copies):
        a = 2 * np.pi * i / copies
        o2w[i, :, :3] = 0.35 * np.eye(3)
        o2w[i, :, 3] = [2.2 * np.cos(a), 0.4, 2.2 * np.sin(a)]
        mb.add_mesh(v @ o2w[i, :, :3].T + o2w[i, :, 3], f, 2, uv)
    arrays = assemble(mb.build(), [[0.73, 0.73, 0.73], [0, 0, 0], [0.3, 0.5, 0.7]],
                      [[0, 0, 0], [14.0, 14.0, 14.0], [0, 0, 0]], [-1, -1, -1], None,
                      camera([0.0, 2.5, 5.0], [0.0, 0.4, 0.0], 45.0))
    arrays["instances"] = {"objects": {"verts": v, "idx": f}, "obj_of_inst":
                           np.zeros(copies, np.int32), "o2w": o2w}
    return arrays
"""

#: A configuration's own reference: render's two functions, each call
#: noted with the `instances` group it was handed.
_NOTING_REFERENCE = """
import json
from pathlib import Path

from raybench.reference import render

CALLS = Path(__file__).with_suffix(".calls")


def _note(fn, arrays):
    inst = arrays.get("instances", {})
    with open(CALLS, "a") as fh:
        fh.write(json.dumps({"fn": fn, "instances": sorted(inst),
                             "copies": len(inst.get("o2w", ()))}) + "\\n")


def loss_and_grads(arrays, *args, **kwargs):
    _note("loss_and_grads", arrays)
    return render.loss_and_grads(arrays, *args, **kwargs)


def frame_pixels(arrays, *args, **kwargs):
    _note("frame_pixels", arrays)
    return render.frame_pixels(arrays, *args, **kwargs)
"""


def _add_instanced_config(root, at, scene="instanced", reference="noting"):
    """Copy raybench/ to `at` and add, as new files and manifest entries
    only, a configuration with its own scene and reference, and its cell
    under the frame mix; the cell's name and the manifest."""
    shutil.copytree(root / "raybench", at / "raybench")
    rb = at / "raybench"
    (rb / "scenes" / "instanced.py").write_text(_INSTANCED_SCENE)
    (rb / "reference" / "noting.py").write_text(_NOTING_REFERENCE)
    (rb / "configs" / "instanced.json").write_text(json.dumps({
        "name": "instanced", "scene": scene, "scene_args": {"copies": 64, "subdiv": 3},
        "reference": reference, "render": {"backend": "wide"}}))
    (rb / "traffic" / "frame_tiny.json").write_text(json.dumps({
        "kind": "render", "render": {"width": 16, "height": 16, "spp": 2,
                                     "integrator": "direct", "deterministic": False},
        "warmup_steps": 1, "trace": {"skip_steps": 1, "steps": 1},
        "check": {"steps": 1, "pixels": 64}}))
    (rb / "limits" / "instanced.frame_tiny.json").write_text(
        json.dumps({"px_mean_rel": 1e-4, "px_off": 0.0}))
    m = _manifest(root)
    m["configs"].append({"name": "instanced", "source": "a test", "reduced": [],
                         "file": "raybench/configs/instanced.json", "why": "a dummy"})
    m["workloads"].append({"name": "instanced.frame_tiny", "config": "instanced",
                           "traffic": "frame_tiny", "chips": 1, "why": "a dummy"})
    return "instanced.frame_tiny", m


def test_a_configuration_is_added_with_files_only(root, tmp_path, tiny_cell):
    """A configuration with a scene file and a reference file of its own
    runs correct, at its scene's TINY_ARGS; its reference is the one
    compared with and is handed the scene's `instances` group; no file of
    the harness changes."""
    name, m = _add_instanced_config(root, tmp_path)
    spec = tiny_cell(name, tmp_path, m)
    assert spec.config["scene_args"] == {"copies": 8, "subdiv": 2}
    r = bench.run_cell(spec, 2**31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert r["correct"], r
    calls = [json.loads(x) for x in
             (tmp_path / "raybench" / "reference" / "noting.calls").read_text().splitlines()]
    assert calls == [{"fn": "frame_pixels", "instances": ["o2w", "obj_of_inst", "objects"],
                      "copies": 8}]
    for f in (root / "raybench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (tmp_path / f.relative_to(root)).read_bytes() == f.read_bytes(), f


@pytest.mark.parametrize("what", ["scene", "reference"])
def test_a_missing_scene_or_reference_file_is_named(root, tmp_path, what):
    name, m = _add_instanced_config(root, tmp_path, **{what: "absent"})
    folder = {"scene": "scenes", "reference": "reference"}[what]
    missing = tmp_path / "raybench" / folder / "absent.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        bench.cell_spec(tmp_path, name, manifest=m)


def test_the_reference_refuses_an_integrator_it_does_not_render():
    from raybench.reference import render as ref

    assert ref.settings({"integrator": "path"})["max_depth"] == 4
    with pytest.raises(KeyError, match="no integrator"):
        ref.settings({"integrator": "volumetric"})
