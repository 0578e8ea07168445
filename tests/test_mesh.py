"""OBJ mesh loading (models/mesh.py): parser forms, transforms, scene-JSON
``meshes`` expansion, the procedural icosphere scenes, and render parity of
mesh triangles through the baked and array traversals."""

import json

import jax
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import mesh as mesh_mod
from terminal_raytracer.models import scene as scene_mod
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer

POSE = Camera().pose()

MAT = scene_mod.Material(color=(0.5, 0.5, 0.5), emission=(0.0, 0.0, 0.0),
                         reflectivity=0.0)


# ---- parser ----------------------------------------------------------------


def test_parse_obj_forms():
    """All face index forms, comments, extra vertex fields, fan
    triangulation, negative (relative) indices."""
    text = """
# comment
v 0 0 0
v 1 0 0  # trailing comment
v 1 1 0 1.0
v 0 1 0
f 1 2 3 4
f 1/5 2/6/7 3//8
f -4 -3 -2
"""
    verts, faces = mesh_mod.parse_obj(text)
    assert len(verts) == 4
    assert verts[2] == (1.0, 1.0, 0.0)  # extra field ignored
    # quad fans into 2 tris; the other two records are one tri each
    assert faces == [(0, 1, 2), (0, 2, 3), (0, 1, 2), (0, 1, 2)]


@pytest.mark.parametrize("bad,msg", [
    ("v 1 2", "3 coordinates"),
    ("v a b c", "bad vertex"),
    ("f 1 2", ">= 3 vertices"),
    ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 x", "bad face index"),
    ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 0", "1-based"),
    ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9", "out of range"),
    ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 -4", "out of range"),
])
def test_parse_obj_errors(bad, msg):
    with pytest.raises(ValueError, match=msg):
        mesh_mod.parse_obj(bad)


def test_transforms_and_narrowing():
    """scale -> rotate_y -> translate in f64, narrowed to f32 at Triangle
    construction (the JSON loader's discipline, models/scene.py _f32v)."""
    verts = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)]
    tris = mesh_mod.mesh_triangles(
        verts, [(0, 1, 2)], MAT, scale=2.0, translate=(0.0, 0.0, -5.0),
        rotate_y_degrees=90.0,
    )
    assert len(tris) == 1
    t = tris[0]
    # (1,0,0) *2 -> rot90 about +Y (right-handed: x->-z... here x -> -z)
    v0 = np.asarray(t.v0)
    assert np.allclose(v0, [0.0, 0.0, -7.0], atol=1e-6)
    assert np.allclose(np.asarray(t.v1), [0.0, 2.0, -5.0], atol=1e-6)
    # f32-narrowed exactly
    for v in (t.v0, t.v1, t.v2):
        for c in v:
            assert c == float(np.float32(c))


def test_per_axis_scale_and_degenerate_drop():
    verts = [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]
    tris = mesh_mod.mesh_triangles(verts, [(0, 1, 2)], MAT,
                                   scale=(1.0, 0.0, 1.0))  # squashes flat
    assert tris == ()  # zero-area face dropped
    tris = mesh_mod.mesh_triangles(verts, [(0, 1, 2), (0, 0, 1)], MAT)
    assert len(tris) == 1  # the repeated-vertex face is degenerate


def test_bad_spec_errors(tmp_path):
    with pytest.raises(ValueError, match="'obj' path"):
        mesh_mod.triangles_from_spec({"color": [1, 1, 1]})
    with pytest.raises(FileNotFoundError):
        mesh_mod.triangles_from_spec(
            {"obj": "nope.obj", "color": [1, 1, 1], "emission": [0, 0, 0],
             "reflectivity": 0.0}, base_dir=tmp_path)
    with pytest.raises(ValueError, match="scale"):
        obj = tmp_path / "t.obj"
        obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        mesh_mod.triangles_from_spec(
            {"obj": str(obj), "color": [1, 1, 1], "emission": [0, 0, 0],
             "reflectivity": 0.0, "scale": [1, 2]})


# ---- scene integration ------------------------------------------------------


def test_scene_json_meshes(tmp_path):
    """`meshes` entries expand into triangles AFTER the JSON triangles
    (reference flatten order preserved for everything it can express), with
    relative OBJ paths resolved against the scene file's directory."""
    (tmp_path / "tri.obj").write_text(
        "v 0 0 -5\nv 1 0 -5\nv 0 1 -5\nf 1 2 3\n")
    cfg = {
        "width": 32, "height": 16, "samples_per_pixel": 1, "max_depth": 2,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 0.55},
        "triangles": [
            {"v0": [0, 0, -9], "v1": [1, 0, -9], "v2": [0, 1, -9],
             "color": [1, 0, 0], "emission": [0, 0, 0], "reflectivity": 0.0}
        ],
        "meshes": [
            {"obj": "tri.obj", "color": [0, 1, 0], "emission": [0, 0, 0],
             "reflectivity": 0.5}
        ],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(cfg))
    scene = load_scene(str(path))
    assert len(scene.triangles) == 2
    assert scene.triangles[0].material.color == (1.0, 0.0, 0.0)  # JSON first
    assert scene.triangles[1].material.color == (0.0, 1.0, 0.0)
    assert scene.triangles[1].material.reflectivity == 0.5
    assert scene.triangles[1].v0 == (0.0, 0.0, -5.0)


def test_packaged_mesh_demo():
    scene = load_scene("mesh_demo")
    assert len(scene.triangles) == 20  # the icosahedron
    assert scene.primitive_count == 23


def test_icosphere_spec():
    scene = load_scene("icosphere:1")
    assert len(scene.triangles) == 80
    assert len(scene.lights) == 1
    with pytest.raises(ValueError, match="icosphere:S"):
        load_scene("icosphere:x")
    # seed jitters the mesh yaw
    assert load_scene("icosphere:1:1").triangles[0] != scene.triangles[0]


def test_icosphere_counts():
    for s, n in ((0, 20), (1, 80), (2, 320)):
        _verts, faces = mesh_mod.icosphere(s)
        assert len(faces) == n


# ---- render parity ----------------------------------------------------------


def _render(scene, accel):
    return jax.device_get(jax.jit(
        PathTracer(scene, accel=accel).render_frame
    )(POSE, np.uint32(5), np.int32(0)))


def test_mesh_baked_vs_array():
    """Mesh triangles through both traversals: identical control flow (ray
    counts, sample totals) and radiance to float rounding. Exact bitwise
    equality holds for straight-line sweeps; on CPU XLA a
    fori_loop body can contract FMAs differently than unrolled code (<= 1
    ulp, ops/arrayscene._fori docstring), so radiance is pinned with a
    tight allclose here."""
    scene = load_scene("mesh_demo").with_overrides(
        width=64, height=16, samples_per_pixel=4, max_depth=3)
    cb, vb, tb, rb = _render(scene, "baked")
    ca, va, ta, ra = _render(scene, "array")
    assert float(rb) == float(ra)
    np.testing.assert_array_equal(np.asarray(tb), np.asarray(ta))
    for q, (b, a) in (("x", (cb.x, ca.x)), ("y", (cb.y, ca.y)),
                      ("z", (cb.z, ca.z)), ("var", (vb, va))):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=3e-6,
                                   atol=1e-6, err_msg=q)


def test_mesh_pallas_matches_oracle():
    """The GPU kernel renders mesh triangles through the array sweep
    (input-ref fori reads) and agrees with the array oracle."""
    scene = load_scene("icosphere:1").with_overrides(
        width=128, height=16, samples_per_pixel=4, max_depth=2)
    co, _vo, to, ro = _render(scene, "array")
    pf = jax.jit(pallas_kernel.make_render_frame(scene, accel="array",
                                                 interpret=True))
    cp, _vp, tp, rp, _occ = jax.device_get(pf(POSE, np.uint32(5), np.int32(0)))
    assert float(rp) == float(ro)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(to))
    np.testing.assert_allclose(np.asarray(cp.x), np.asarray(co.x), atol=2e-5)


def test_mesh_composes_with_animate():
    """An animated scene containing mesh triangles: the animator's keys
    stream at runtime, the mesh folds back to baked constants. Frames must
    differ (geometry moves) and match the fully-dynamic render at equal
    values (the DynPrims folding contract, test_dynamic.py)."""
    from terminal_raytracer.models.animate import ANIMATOR_KEYS, orbit
    from terminal_raytracer.ops.dynamic import pack_scene

    scene = load_scene("mesh_demo").with_overrides(
        width=64, height=16, samples_per_pixel=2, max_depth=3)
    arrays0 = pack_scene(scene)
    tr = PathTracer(scene, dynamic=True, dyn_animated=ANIMATOR_KEYS["orbit"])
    f = jax.jit(tr.render_frame_dynamic)

    c0, _v, _t, r0 = jax.device_get(
        f(POSE, np.uint32(5), np.int32(0), orbit(arrays0, 0)))
    c5, _v, _t, r5 = jax.device_get(
        f(POSE, np.uint32(5), np.int32(0), orbit(arrays0, 5)))
    assert not np.array_equal(np.asarray(c0.x), np.asarray(c5.x))

    full = PathTracer(scene, dynamic=True)  # every key runtime
    cf, _v, _t, rf = jax.device_get(jax.jit(full.render_frame_dynamic)(
        POSE, np.uint32(5), np.int32(0), orbit(arrays0, 5)))
    assert float(r5) == float(rf)
    np.testing.assert_array_equal(np.asarray(c5.x), np.asarray(cf.x))
