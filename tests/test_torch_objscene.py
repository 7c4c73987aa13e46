"""OBJ/MTL loading and scene assembly of the port against the JAX package.

Every OBJ/MTL case of tests/test_objloader.py and tests/test_scene.py is
written under tmp_path and read by both packages; the arrays must be equal
(the loaders are host numpy code in both, so exactly). The port's native
parser must give its Python parser's arrays, concave faces included.
"""

import dataclasses

import numpy as np
import pytest

from path_tracer_ai_tpu.scene import objloader as jobj
from path_tracer_ai_tpu.scene import scene as jscene
from path_tracer_ai_tpu.scene.cornell import build_cornell_scene as jcornell
from path_tracer_ai_tpu_torch.accel import native
from path_tracer_ai_tpu_torch.scene import objloader, scene
from path_tracer_ai_tpu_torch.scene.cornell import build_cornell_scene
from path_tracer_ai_tpu_torch.scene.procgen import write_blob_obj

OBJ_FIELDS = ("vertices", "normals", "texcoords", "v_idx", "n_idx", "t_idx",
              "mat_ids")

MTL_AB = "newmtl a\nKd 1 0 0\nnewmtl b\nKd 0 1 0\n"
MTL_SIMPLE = """
newmtl gold_plate
Kd 0.5 0.5 0.5
newmtl plain_blue
Kd 0.1 0.2 0.9
newmtl glass_visor
Kd 1 1 1
illum 7
Ni 1.45
"""
MTL_PARSING = """
newmtl gold_body
Kd 0.8 0.6 0.1
Ni 1.45
newmtl glass_visor
Kd 1 1 1
d 0.3
illum 7
"""

# name -> {file name: text}; the OBJ is the one file ending in .obj.
CASES = {
    "basic_triangle": {"t.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"},
    "quad_fan": {"q.obj": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"},
    "negative_indices": {"n.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"},
    "full_face_format": {"ff.obj": (
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\nvn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\n")},
    "vn_only": {"vn.obj": (
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\nf 1//1 2//1 3//1\n")},
    "usemtl_per_face": {"m.mtl": MTL_AB, "u.obj": (
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\nusemtl b\n"
        "f 1 2 3\nusemtl a\nf 1 2 3\nusemtl nonexistent\nf 1 2 3\n")},
    "concave_arrowhead": {"concave.obj": (
        "v 0 0 0\nv 4 1 0\nv 0 2 0\nv 1 1 0\nf 1 2 3 4\n")},
    "concave_mixed": {"concave2.obj": (
        "v 0 0 0\nv 4 1 0\nv 0 2 0\nv 1 1 0\n"
        "v 0 0 3\nv 2 0 3\nv 2 2 3\nv 1 0.5 3\nv 0 2 3\n"
        "v 5 0 0\nv 6 0 0\nv 6 0 1\nv 5 0 1\n"
        "f 1 2 3 4\nf 5 6 7 8 9\nf 10 11 12 13\n")},
    "convex_pentagon": {"convex.obj": (
        "v 0 0 0\nv 2 0 0\nv 3 1 0\nv 2 2 0\nv 0 2 0\nf 1 2 3 4 5\n")},
    # tests/test_scene.py's model: a face-normal fallback, an unreferenced
    # vertex that still shapes the bounds, three MTL materials
    "scene_simple": {"mats.mtl": MTL_SIMPLE, "model.obj": (
        "mtllib mats.mtl\nv 0 0 0\nv 2 0 0\nv 2 2 0\nv 0 0 2\n"
        "usemtl gold_plate\nf 1 2 3\n")},
    "uv_and_partial_normals": {"mats.mtl": MTL_SIMPLE, "p.obj": (
        "mtllib mats.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
        "vt 0.25 0.5\nvt 1 0\nvn 0 0 2\nvn 0 1 0\n"
        "usemtl plain_blue\nf 1/1/1 2/2/1 3//2\n"
        "usemtl glass_visor\nf 1/1 3 4/2/2\nf 2//2 5//1 3\n")},
}


def _write(tmp_path, files):
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return str(tmp_path / next(n for n in files if n.endswith(".obj")))


def _assert_obj_equal(ours, ref):
    for f in OBJ_FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ([dataclasses.astuple(m) for m in ours.materials]
            == [dataclasses.astuple(m) for m in ref.materials])


def _assert_scene_equal(ours, ref):
    for part in ("triangles", "materials", "lights"):
        for a, b in zip(getattr(ours, part), getattr(ref, part)):
            b = np.asarray(b)
            a = a.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, part
            np.testing.assert_array_equal(a, b, err_msg=part)


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_obj_matches_jax(tmp_path, case):
    path = _write(tmp_path, CASES[case])
    ref = jobj.load_obj(path)
    _assert_obj_equal(objloader.load_obj(path), ref)
    _assert_obj_equal(objloader._load_obj_py(path), ref)


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_parser_equals_python_parser(tmp_path, case):
    if not native.available():
        pytest.skip("native library unavailable (make -C native failed)")
    path = _write(tmp_path, CASES[case])
    nat = native.native_load_obj(path)
    assert nat.parser == "native"
    py = objloader._load_obj_py(path)
    assert py.parser == "python"
    _assert_obj_equal(nat, py)


def test_blob_obj_both_parsers_match_jax(tmp_path):
    """The written blob (the CLI phase's model, here at subdiv 2): vn
    normals, two materials; both parsers and JAX agree."""
    path = str(tmp_path / "blob.obj")
    assert write_blob_obj(path, subdivisions=2) == 320
    ref = jobj.load_obj(path)
    assert ref.mat_ids.tolist() == [0] * 160 + [1] * 160
    _assert_obj_equal(objloader.load_obj(path), ref)
    _assert_obj_equal(objloader._load_obj_py(path), ref)
    _assert_scene_equal(scene.build_scene(path, device="cpu"),
                        jscene.build_scene(path))


@pytest.mark.parametrize("case", ["mtl_parsing", "default_kd"])
def test_parse_mtl_matches_jax(tmp_path, case):
    text = MTL_PARSING if case == "mtl_parsing" else "newmtl plain\n"
    p = tmp_path / "m.mtl"
    p.write_text(text)
    ours, ref = objloader.parse_mtl(str(p)), jobj.parse_mtl(str(p))
    assert [dataclasses.astuple(m) for m in ours] == [
        dataclasses.astuple(m) for m in ref]


@pytest.mark.parametrize("raw,count", [("", 5), ("3", 5), ("-1", 5),
                                       ("-5", 5), ("7", 2)])
def test_resolve_index_matches_jax(raw, count):
    assert objloader._resolve_index(raw, count) == jobj._resolve_index(raw,
                                                                         count)


def test_concave_face_is_ear_clipped(tmp_path):
    """The arrowhead's reflex corner: no triangle of the fan (0, 2, 3)."""
    data = objloader.load_obj(_write(tmp_path, CASES["concave_arrowhead"]))
    assert data.v_idx.shape == (2, 3)
    assert [0, 2, 3] not in data.v_idx.tolist()


@pytest.mark.parametrize("case,kw", [
    (c, kw) for c in sorted(CASES)
    for kw in ({}, {"enable_dielectrics": True}, {"include_room": False})])
def test_build_scene_matches_jax(tmp_path, case, kw):
    path = _write(tmp_path, CASES[case])
    _assert_scene_equal(scene.build_scene(path, device="cpu", **kw),
                        jscene.build_scene(path, **kw))


def test_build_scene_invariants(tmp_path):
    """tests/test_scene.py's asserts on the port's scene."""
    from path_tracer_ai_tpu_torch.core.types import (
        MATERIAL_DIELECTRIC,
        MATERIAL_SPECULAR,
    )

    path = _write(tmp_path, CASES["scene_simple"])
    s = scene.build_scene(path, device="cpu")
    t, m = s.triangles, s.materials
    assert t.count == 9 and m.count == 5
    np.testing.assert_array_equal(t.mat_id[:8].numpy(), [1] * 8)
    assert int(t.mat_id[8]) == 2  # gold_plate: MTL index 0 + 2
    np.testing.assert_allclose(t.v0[8].numpy(), [-1.5, 0.3, 1.5], atol=1e-6)
    np.testing.assert_allclose(m.albedo[2].numpy(), [1.0, 0.8, 0.0])
    assert int(m.mtype[4]) == MATERIAL_SPECULAR
    d = scene.build_scene(path, enable_dielectrics=True, device="cpu")
    assert int(d.materials.mtype[4]) == MATERIAL_DIELECTRIC
    np.testing.assert_allclose(float(d.materials.ior[4]), 1.45)


@pytest.mark.parametrize("name", ["red_x", "gold_x", "darksilver", "black_x",
                                  "plain", "glass", "dielectric_x"])
@pytest.mark.parametrize("dielectrics", [False, True])
def test_convert_mtl_material_matches_jax(name, dielectrics):
    for extra in ({}, {"illum": 7}, {"dissolve": 0.5, "ior": 0.0}):
        m = objloader.ObjMaterial(name=name, diffuse=(0.1, 0.7, 1.3), **extra)
        jm = jobj.ObjMaterial(name=name, diffuse=(0.1, 0.7, 1.3), **extra)
        assert (dataclasses.astuple(scene._convert_mtl_material(m, dielectrics))
                == dataclasses.astuple(
                    jscene._convert_mtl_material(jm, dielectrics)))


def test_scene_constants_match_jax():
    for name in ("MODEL_TARGET_SIZE", "MODEL_LIFT_Y", "MTL_MATERIAL_OFFSET",
                 "ROOM_SIZE", "ROOM_HEIGHT", "WALL_MAT_ID", "DEFAULT_LIGHTS",
                 "ROOM_TRIANGLES"):
        assert getattr(scene, name) == getattr(jscene, name), name
    raw = np.random.default_rng(0).standard_normal((16, 3)).astype(np.float32)
    center = np.asarray([0.5, -1.0, 2.0], np.float32)
    np.testing.assert_array_equal(
        scene.transform_model_vertices(raw, center, 1.7),
        jscene.transform_model_vertices(raw, center, 1.7))


def test_empty_obj(tmp_path):
    """Vertices but no face: the room alone, or ValueError without it."""
    path = _write(tmp_path, {"e.obj": "v 0 0 0\nv 1 2 3\n"})
    _assert_scene_equal(scene.build_scene(path, device="cpu"),
                        jscene.build_scene(path))
    for build in (lambda: scene.build_scene(path, include_room=False,
                                            device="cpu"),
                  lambda: jscene.build_scene(path, include_room=False)):
        with pytest.raises(ValueError, match="no triangles"):
            build()


def test_missing_file_raises(tmp_path):
    with pytest.raises(OSError):
        scene.build_scene(str(tmp_path / "missing.obj"), device="cpu")


def test_cornell_matches_jax():
    ours, cam = build_cornell_scene(device="cpu")
    ref, jcam = jcornell()
    _assert_scene_equal(ours, ref)
    for a, b in zip(cam, jcam):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

