"""Normal mapping — capability extension tests.

Per-primitive `normal_map` / `normal_scale` / `normal_strength`
(models/scene.py) perturb the shading normal from a tangent-space texture
(ops/tracer.py _apply_normal_map): rgb -> [-1,1] xyz with z along the
geometric normal, the tangent frame following the uv mapping (planar
world-axis pairs; spherical longitude tangent). Same contract as the other
extension channels: statically gated (scenes without normal maps compile
the exact prior program — no channels, no fetch, no frame math), threaded
through all four traversals, and agreeing across every Pallas scheduler.
No RNG draws are added (the perturbation bends directions, not branch
probabilities), but bent paths legitimately change later hit/miss
outcomes — so cross-backend agreement is pinned per scene, not against
the unmapped render.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import dynamic as dyn_mod
from terminal_raytracer.ops import geometry as geom
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops import vecmath as vm
from terminal_raytracer.ops.tracer import PathTracer

POSE = Camera().pose()

_FLAT = {"pixels": [[[128, 128, 255]] * 4] * 4}  # ~identity map
# Constant +u tilt: x = 255 -> tn.x = 1, z = 255 -> tn.z = 1 (a 45-degree
# tangential bend at strength 1; y = 128 leaves ~0.004 of quantization).
_TILT_U = {"pixels": [[[255, 128, 255]] * 4] * 4}


def _nm_scene(**overrides):
    cfg = {
        "width": 64, "height": 16, "samples_per_pixel": 4, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "texture_size": 16,
        "textures": {"flat": copy.deepcopy(_FLAT)},
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [0.8, 0.8, 0.8], "emission": [0, 0, 0],
                    "reflectivity": 0.0, "normal_map": "flat"}],
        "spheres": [{"center": [0, 5, -3], "radius": 1.0,
                     "color": [0, 0, 0], "emission": [10, 10, 10],
                     "reflectivity": 0.0},
                    {"center": [0, 0, -3], "radius": 1.0,
                     "color": [1, 1, 1], "emission": [0, 0, 0],
                     "reflectivity": 0.0, "normal_map": "flat"}],
    }
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


def _strip_nm(scene):
    import dataclasses

    def strip(prims):
        return tuple(p._replace(material=p.material._replace(
            normal_map=None)) for p in prims)

    return dataclasses.replace(scene, spheres=strip(scene.spheres),
                               planes=strip(scene.planes),
                               triangles=strip(scene.triangles),
                               textures=())


def _render(tracer, seed=42, frame=0):
    return jax.jit(tracer.render_frame)(POSE, np.uint32(seed),
                                        np.int32(frame))


# ---------------------------------------------------------------------------
# Schema / gates
# ---------------------------------------------------------------------------


def test_schema_and_gates():
    s = _nm_scene()
    assert s.has_normal_map and s.needs_atlas and not s.has_texture
    # signed id convention matches texture_channel
    assert s.normal_channel(sm.PLANE, s.planes[0].material) == (1.0, 1.0,
                                                                1.0)
    assert s.normal_channel(sm.SPHERE, s.spheres[1].material)[0] == -1.0
    assert s.normal_channel(sm.SPHERE, s.spheres[0].material) == (0.0, 0.0,
                                                                  0.0)
    assert {"p_nmi", "p_nmx", "p_nms"} <= {k for k, _ in
                                           dyn_mod.scene_keys(s)}
    plain = load_scene("Cornell_Box")
    assert not plain.has_normal_map
    assert not any("_nm" in k for k, _ in dyn_mod.scene_keys(plain))


def test_loader_validation():
    with pytest.raises(ValueError, match="normal_map"):
        _nm_scene(planes=[{"point": [0, -1, 0], "normal": [0, 1, 0],
                           "color": [1, 1, 1], "emission": [0, 0, 0],
                           "reflectivity": 0.0, "normal_strength": 2.0}])
    with pytest.raises(ValueError, match="nope"):
        _nm_scene(planes=[{"point": [0, -1, 0], "normal": [0, 1, 0],
                           "color": [1, 1, 1], "emission": [0, 0, 0],
                           "reflectivity": 0.0, "normal_map": "nope"}])
    for field, val in (("normal_strength", 0.0), ("normal_scale", -1.0)):
        with pytest.raises(ValueError, match=field):
            _nm_scene(planes=[{"point": [0, -1, 0], "normal": [0, 1, 0],
                               "color": [1, 1, 1], "emission": [0, 0, 0],
                               "reflectivity": 0.0, "normal_map": "flat",
                               field: val}])


# ---------------------------------------------------------------------------
# Perturbation math (unit level, fabricated hits)
# ---------------------------------------------------------------------------


def _unit_hit(tracer, normal, p, nm_id, scale=1.0, strength=1.0):
    lanes = jnp.zeros((1, 1), jnp.float32)

    def v3(t):
        return vm.V3(lanes + t[0], lanes + t[1], lanes + t[2])

    return geom.Hit(
        found=lanes > -1, t=lanes + 1.0, p=v3(p), normal=v3(normal),
        color=v3((1, 1, 1)), emission=v3((0, 0, 0)), reflectivity=lanes,
        light_inv_area=lanes, nm_index=lanes + nm_id,
        nm_scale=lanes + scale, nm_strength=lanes + strength,
    )


def _applied_normal(scene, normal, p, nm_id, strength=1.0):
    t = PathTracer(scene)
    hit = _unit_hit(t, normal, p, nm_id, strength=strength)
    out = jax.jit(t._apply_normal_map)(hit)
    return np.array([float(out.normal.x[0, 0]), float(out.normal.y[0, 0]),
                     float(out.normal.z[0, 0])])


def test_planar_tangent_frame():
    # y-up floor (y-dominant): u = p.x -> T = +x. The +u tilt map bends
    # the normal 45 degrees toward +x (tn.x = tn.z = 1); the residual y/z
    # components are the 8-bit quantization of the map's 128s (~0.004).
    scene = _nm_scene(textures={"flat": copy.deepcopy(_TILT_U)})
    n = _applied_normal(scene, (0, 1, 0), (0.11, -1, -3.07), 1.0)
    np.testing.assert_allclose(n, [2**-0.5, 2**-0.5, 0.0], atol=0.01)
    # identity-ish flat map: unchanged within the 8-bit quantization step
    scene2 = _nm_scene()
    n2 = _applied_normal(scene2, (0, 1, 0), (0.11, -1, -3.07), 1.0)
    np.testing.assert_allclose(n2, [0, 1, 0], atol=0.005)
    # unmapped lane (id 0): bitwise unchanged
    n3 = _applied_normal(scene2, (0, 1, 0), (0.11, -1, -3.07), 0.0)
    assert tuple(n3) == (0.0, 1.0, 0.0)


def test_spherical_tangent_frame():
    # normal +z: longitude tangent T = (-n.z, 0, n.x)/|..| = (-1, 0, 0),
    # bitangent B = cross(n, T) = (0, -1, 0). The +u tilt bends 45 degrees
    # toward -x.
    scene = _nm_scene(textures={"flat": copy.deepcopy(_TILT_U)})
    n = _applied_normal(scene, (0, 0, 1), (0, 0, 1), -1.0)
    np.testing.assert_allclose(n, [-(2**-0.5), 0.0, 2**-0.5], atol=0.01)
    # pole guard: normal +y has no longitude — falls back to +x tangent
    n2 = _applied_normal(scene, (0, 1, 0), (0, 1, 0), -1.0)
    assert np.isfinite(n2).all()
    np.testing.assert_allclose(np.linalg.norm(n2), 1.0, rtol=1e-5)


def test_strength_scales_deflection():
    scene = _nm_scene(textures={"flat": copy.deepcopy(_TILT_U)})
    weak = _applied_normal(scene, (0, 1, 0), (0.2, -1, -3), 1.0,
                           strength=0.05)
    strong = _applied_normal(scene, (0, 1, 0), (0.2, -1, -3), 1.0,
                             strength=1.0)
    # deflection angle ~ atan(strength * tn.x / tn.z)
    np.testing.assert_allclose(weak[0], 0.05, atol=0.01)
    np.testing.assert_allclose(strong[0], 2**-0.5, atol=0.01)
    np.testing.assert_allclose(np.linalg.norm(weak), 1.0, rtol=1e-5)


# ---------------------------------------------------------------------------
# Render-level agreement
# ---------------------------------------------------------------------------


def test_flat_map_barely_changes_the_render():
    # The ~identity map (all texels 128,128,255) perturbs by only the
    # 8-bit quantization (~0.4 degrees): radiance stays close to the
    # stripped scene. (Exact ray-count equality is NOT expected even
    # then — bent scatter directions legitimately change later hit/miss
    # outcomes; cross-backend agreement is pinned by the scheduler test.)
    scene = _nm_scene()
    cur, *_ = _render(PathTracer(scene))
    cur0, *_ = _render(PathTracer(_strip_nm(scene)))
    a, b = np.asarray(cur.x), np.asarray(cur0.x)
    assert np.median(np.abs(a - b)) < 0.02


def test_shading_actually_changes():
    scene = _nm_scene(textures={"flat": copy.deepcopy(_TILT_U)})
    cur, *_ = _render(PathTracer(scene))
    cur0, *_ = _render(PathTracer(_strip_nm(scene)))
    assert not np.allclose(np.asarray(cur.x), np.asarray(cur0.x), atol=1e-3)


def test_traversals_agree():
    scene = _nm_scene(textures={"flat": copy.deepcopy(_TILT_U)})
    cur, _var, tot, rays = _render(PathTracer(scene))
    for accel in ("array", "grid"):
        c2, _v2, t2, r2 = _render(PathTracer(scene, accel=accel))
        assert float(r2) == float(rays), accel
        for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-5, err_msg=accel)
    t_dyn = PathTracer(scene, dynamic=True)
    c3, _v3, t3, r3 = jax.jit(
        lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a)
    )(POSE, np.uint32(42), np.int32(0), dyn_mod.pack_scene(scene))
    assert float(r3) == float(rays)
    for a, b in ((c3.x, cur.x), (c3.y, cur.y), (c3.z, cur.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)


def test_pallas_schedulers_match_oracle():
    scene = _nm_scene(width=128, height=8,
                      textures={"flat": copy.deepcopy(_TILT_U)})
    cur_o, _vo, tot_o, rays_o = _render(PathTracer(scene))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42),
                                         np.int32(0))
    err = "kernel"
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o),
                                  err)
    assert float(rays_p) == float(rays_o), err
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y),
                 (cur_p.z, cur_o.z)):
        diff = np.abs(np.asarray(a) - np.asarray(b))
        outliers = int((diff > 2e-5).sum())
        assert outliers <= diff.size // 100, (err, outliers)
        assert np.median(diff) < 2e-6, (err, float(np.median(diff)))


def test_composes_with_color_texture_and_bilinear():
    # One primitive carrying BOTH a color texture and a normal map (two
    # fetches, two channel pairs), under the bilinear filter.
    quad = {"pixels": [[[255, 0, 0], [0, 255, 0]],
                       [[0, 0, 255], [255, 255, 255]]]}
    scene = _nm_scene(
        textures={"flat": copy.deepcopy(_TILT_U), "quad": quad},
        texture_filter="bilinear",
        planes=[{"point": [0, -1, 0], "normal": [0, 1, 0],
                 "color": [0.8, 0.8, 0.8], "emission": [0, 0, 0],
                 "reflectivity": 0.0, "normal_map": "flat",
                 "texture": "quad", "texture_scale": 0.5}],
    )
    assert scene.has_texture and scene.has_normal_map
    t = PathTracer(scene)
    # separate static sweep ranges: flat = id 1 (nm), quad = id 2 (color)
    assert (t.nm_prim_lo, t.nm_prim_hi) == (0, t.tex_rows)
    assert (t.tex_prim_lo, t.tex_prim_hi) == (t.tex_rows, 2 * t.tex_rows)
    cur, _var, tot, rays = _render(t)
    assert np.isfinite(np.asarray(cur.x)).all() and float(rays) > 0
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    _cp, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42), np.int32(0))
    assert float(rays_p) == float(rays)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot))
