"""Analytic intersection tests vs closed-form answers, including the
reference's root-selection and bound-strictness rules
(reference: src/shader.wgsl:155-294)."""

import jax.numpy as jnp
import numpy as np

from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import geometry as geom
from terminal_raytracer.ops.vecmath import V3


def _lane(x):
    return jnp.asarray(np.array([x], np.float32))


def _v(x, y, z):
    return V3(_lane(x), _lane(y), _lane(z))


ORIGIN = _v(0.0, 0.0, 0.0)
MINUS_Z = _v(0.0, 0.0, -1.0)


def test_sphere_head_on():
    # Unit sphere at z=-5: near root at t=4.
    t = geom.intersect_sphere(ORIGIN, MINUS_Z, V3(0.0, 0.0, -5.0), 1.0, 0.001, 1e10)
    np.testing.assert_allclose(np.asarray(t), 4.0, rtol=1e-6)


def test_sphere_from_inside_picks_far_root():
    # Origin inside the sphere: near root negative -> far root (t=1).
    t = geom.intersect_sphere(ORIGIN, MINUS_Z, V3(0.0, 0.0, 0.0), 1.0, 0.001, 1e10)
    np.testing.assert_allclose(np.asarray(t), 1.0, rtol=1e-6)


def test_sphere_miss_and_behind():
    t = geom.intersect_sphere(ORIGIN, MINUS_Z, V3(5.0, 0.0, -5.0), 1.0, 0.001, 1e10)
    assert float(t[0]) == -1.0
    t = geom.intersect_sphere(ORIGIN, MINUS_Z, V3(0.0, 0.0, 5.0), 1.0, 0.001, 1e10)
    assert float(t[0]) == -1.0


def test_sphere_t_bounds_strict():
    # Near root exactly at t_min is rejected (root <= t_min, wgsl:168).
    t = geom.intersect_sphere(ORIGIN, MINUS_Z, V3(0.0, 0.0, -5.0), 1.0, 4.0, 1e10)
    # near root 4.0 rejected; far root 6.0 accepted
    np.testing.assert_allclose(np.asarray(t), 6.0, rtol=1e-6)
    t = geom.intersect_sphere(ORIGIN, MINUS_Z, V3(0.0, 0.0, -5.0), 1.0, 6.0, 1e10)
    assert float(t[0]) == -1.0


def test_plane_hit_and_parallel():
    t = geom.intersect_plane(
        ORIGIN, _v(0.0, -1.0, 0.0), V3(0.0, -2.0, 0.0), V3(0.0, 1.0, 0.0), 0.001, 1e10
    )
    np.testing.assert_allclose(np.asarray(t), 2.0, rtol=1e-6)
    # Parallel ray misses (|denom| < 1e-4, wgsl:180)
    t = geom.intersect_plane(
        ORIGIN, MINUS_Z, V3(0.0, -2.0, 0.0), V3(0.0, 1.0, 0.0), 0.001, 1e10
    )
    assert float(t[0]) == -1.0


def test_plane_t_bounds_non_strict():
    # Plane accepts t == t_min (wgsl:185 uses t < t_min to reject).
    t = geom.intersect_plane(
        ORIGIN, _v(0.0, -1.0, 0.0), V3(0.0, -2.0, 0.0), V3(0.0, 1.0, 0.0), 2.0, 1e10
    )
    np.testing.assert_allclose(np.asarray(t), 2.0, rtol=1e-6)


def test_plane_unnormalized_normal_same_t():
    # The intersection uses the raw stored normal; scaling it must not
    # change t (it cancels in the ratio).
    t1 = geom.intersect_plane(
        ORIGIN, _v(0.0, -1.0, 0.0), V3(0.0, -2.0, 0.0), V3(0.0, 1.0, 0.0), 0.001, 1e10
    )
    t2 = geom.intersect_plane(
        ORIGIN, _v(0.0, -1.0, 0.0), V3(0.0, -2.0, 0.0), V3(0.0, 7.0, 0.0), 0.001, 1e10
    )
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6)


def _tri_edges(v0, v1, v2):
    v0a, v1a, v2a = (np.array(v, np.float32) for v in (v0, v1, v2))
    return V3(*v0a), V3(*(v1a - v0a)), V3(*(v2a - v0a))


def test_triangle_center_hit():
    v0, e1, e2 = _tri_edges([-1, -1, -3], [1, -1, -3], [0, 1, -3])
    t = geom.intersect_triangle(ORIGIN, MINUS_Z, v0, e1, e2, 0.001, 1e10)
    np.testing.assert_allclose(np.asarray(t), 3.0, rtol=1e-6)


def test_triangle_edge_and_outside():
    v0, e1, e2 = _tri_edges([-1, -1, -3], [1, -1, -3], [0, 1, -3])
    # Outside the triangle (x beyond vertex)
    o = _v(2.0, 0.0, 0.0)
    t = geom.intersect_triangle(o, MINUS_Z, v0, e1, e2, 0.001, 1e10)
    assert float(t[0]) == -1.0
    # Barycentric corner v0 is u=0, v=0 -> inclusive hit
    o = _v(-1.0, -1.0, 0.0)
    t = geom.intersect_triangle(o, MINUS_Z, v0, e1, e2, 0.001, 1e10)
    np.testing.assert_allclose(np.asarray(t), 3.0, rtol=1e-6)


def test_triangle_parallel_miss():
    v0, e1, e2 = _tri_edges([-1, -1, -3], [1, -1, -3], [0, 1, -3])
    d = _v(1.0, 0.0, 0.0)  # in the triangle's plane direction
    t = geom.intersect_triangle(ORIGIN, d, v0, e1, e2, 0.001, 1e10)
    assert float(t[0]) == -1.0


# ---- ScenePrims traversal ----------------------------------------------------


def _mini_scene():
    cfg = {
        "width": 4, "height": 4, "samples_per_pixel": 1, "max_depth": 2,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 90.0, "char_aspect_ratio": 1.0},
        "spheres": [
            {"center": [0, 0, -5], "radius": 1.0, "color": [1, 0, 0],
             "emission": [0, 0, 0], "reflectivity": 0.0},
            {"center": [0, 0, -8], "radius": 1.0, "color": [0, 1, 0],
             "emission": [0, 0, 0], "reflectivity": 0.0},
        ],
        "planes": [
            {"point": [0, -2, 0], "normal": [0, 1, 0], "color": [0, 0, 1],
             "emission": [0, 0, 0], "reflectivity": 0.0},
        ],
    }
    return sm.scene_from_dict(cfg)


def test_closest_hit_picks_nearer():
    prims = geom.ScenePrims(_mini_scene())
    hit = prims.closest_hit(ORIGIN, MINUS_Z)
    assert bool(hit.found[0])
    np.testing.assert_allclose(float(hit.t[0]), 4.0, rtol=1e-6)
    assert float(hit.color.x[0]) == 1.0  # the red (nearer) sphere
    # Normal points back toward the ray origin (front face)
    np.testing.assert_allclose(
        [float(hit.normal.x[0]), float(hit.normal.y[0]), float(hit.normal.z[0])],
        [0, 0, 1], atol=1e-6,
    )


def test_front_face_flip_inside_sphere():
    prims = geom.ScenePrims(_mini_scene())
    o = _v(0.0, 0.0, -5.0)  # inside the red sphere
    hit = prims.closest_hit(o, MINUS_Z)
    # Geometric normal at (0,0,-6) is (0,0,-1) = along ray -> flipped to (0,0,1)
    assert bool(hit.found[0])
    np.testing.assert_allclose(float(hit.normal.z[0]), 1.0, atol=1e-6)


def test_miss_returns_not_found():
    prims = geom.ScenePrims(_mini_scene())
    up = _v(0.0, 1.0, 0.0)
    hit = prims.closest_hit(ORIGIN, up)
    assert not bool(hit.found[0])


def test_occluded():
    prims = geom.ScenePrims(_mini_scene())
    # Ray toward far sphere is blocked by near sphere.
    assert bool(prims.occluded(ORIGIN, MINUS_Z, 0.001, 7.0)[0])
    # Range ending before the near sphere: clear.
    assert not bool(prims.occluded(ORIGIN, MINUS_Z, 0.001, 3.5)[0])
    # Upward: clear.
    assert not bool(prims.occluded(ORIGIN, _v(0.0, 1.0, 0.0), 0.001, 100.0)[0])


def test_occluded2_matches_two_occluded_calls():
    """The fused two-ray any-hit sweep (fuse_nee probe, geometry.occluded2)
    is bit-identical to two occluded() calls: same blocked_* expressions
    per ray, shared-origin subexpressions hoisted (blocked_*2)."""
    prims = geom.ScenePrims([
        (sm.SPHERE, sm.Sphere((0.0, 0.0, -5.0), 1.0, sm.Material((1, 1, 1), (0, 0, 0), 0.0))),
        (sm.SPHERE, sm.Sphere((3.0, 0.5, -4.0), 0.75, sm.Material((1, 1, 1), (0, 0, 0), 0.0))),
        (sm.PLANE, sm.Plane((0.0, -1.0, 0.0), (0.0, 1.0, 0.0),
                            sm.Material((1, 1, 1), (0, 0, 0), 0.0))),
        (sm.TRIANGLE, sm.Triangle((-1.0, 2.0, -3.0), (1.0, 2.0, -3.0),
                                  (0.0, 3.0, -3.0), sm.Material((1, 1, 1), (0, 0, 0), 0.0))),
    ])
    rng = np.random.default_rng(7)
    o = V3(*(jnp.asarray(rng.normal(size=64).astype(np.float32))
             for _ in range(3)))
    def unit():
        d = np.stack([rng.normal(size=64) for _ in range(3)])
        d /= np.sqrt((d * d).sum(0))
        return V3(*(jnp.asarray(r.astype(np.float32)) for r in d))
    d1, d2 = unit(), unit()
    tm1 = jnp.asarray(rng.uniform(0.5, 20.0, size=64).astype(np.float32))
    tm2 = jnp.asarray(rng.uniform(0.5, 20.0, size=64).astype(np.float32))
    b1, b2 = prims.occluded2(o, d1, tm1, d2, tm2)
    r1 = prims.occluded(o, d1, geom.RAY_EPS, tm1)
    r2 = prims.occluded(o, d2, geom.RAY_EPS, tm2)
    np.testing.assert_array_equal(np.asarray(b1), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(b2), np.asarray(r2))
