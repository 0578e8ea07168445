"""Array-resident traversal (ops/arrayscene.py): bit-parity with the baked
sweep, Pallas-vs-oracle agreement, and the accel='auto' threshold."""

import jax
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models.gen import stress_scene
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import ARRAY_AUTO_THRESHOLD, PathTracer

POSE = Camera().pose()


def _small(name, **kw):
    d = dict(width=64, height=16, samples_per_pixel=4, max_depth=3)
    d.update(kw)
    return load_scene(name).with_overrides(**d)


def test_array_bit_identical_to_baked_oracle():
    """Same f32 values, same op order, same overwrite chain -> the array
    sweep must be BIT-identical to the baked sweep (module docstring
    contract), across all three primitive kinds (Cornell: spheres + planes
    + emissive triangles; scene2: triangle; stress: many spheres)."""
    for name in ("scene2", "Cornell_Box", "stress:48"):
        scene = _small(name)
        cb, vb, tb, rb = jax.device_get(jax.jit(
            PathTracer(scene, accel="baked").render_frame
        )(POSE, np.uint32(5), np.int32(0)))
        ca, va, ta, ra = jax.device_get(jax.jit(
            PathTracer(scene, accel="array").render_frame
        )(POSE, np.uint32(5), np.int32(0)))
        assert float(rb) == float(ra), name
        for q, p in (("x", (cb.x, ca.x)), ("y", (cb.y, ca.y)),
                     ("z", (cb.z, ca.z)), ("var", (vb, va)),
                     ("tot", (tb, ta))):
            np.testing.assert_array_equal(np.asarray(p[0]), np.asarray(p[1]),
                                          err_msg=f"{name}:{q}")


def test_array_mis_transport_matches_baked():
    """light_inv_area rides the fori carry — the MIS weights must agree
    with the baked path exactly."""
    scene = _small("Cornell_Box")
    cb, _vb, _tb, rb = jax.device_get(jax.jit(
        PathTracer(scene, accel="baked", transport="mis").render_frame
    )(POSE, np.uint32(9), np.int32(0)))
    ca, _va, _ta, ra = jax.device_get(jax.jit(
        PathTracer(scene, accel="array", transport="mis").render_frame
    )(POSE, np.uint32(9), np.int32(0)))
    assert float(rb) == float(ra)
    np.testing.assert_array_equal(np.asarray(cb.x), np.asarray(ca.x))


def test_array_pallas_matches_oracle():
    """The GPU kernel consumes the SoA arrays through input refs
    (fori_loop dynamic reads) and agrees with the array oracle: ray counts
    exact, radiance to interpret-mode float rounding."""
    scene = stress_scene(48, seed=3, width=128, height=16,
                         samples_per_pixel=8, max_depth=2)
    co, _vo, to, ro = jax.device_get(jax.jit(
        PathTracer(scene, accel="array").render_frame
    )(POSE, np.uint32(7), np.int32(0)))
    pf = jax.jit(pallas_kernel.make_render_frame(
        scene, interpret=True, accel="array"
    ))
    cp, _vp, tp, rp, _occ = jax.device_get(
        pf(POSE, np.uint32(7), np.int32(0)))
    assert float(rp) == float(ro)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(to))
    np.testing.assert_allclose(np.asarray(cp.x), np.asarray(co.x),
                               atol=2e-5, err_msg="kernel")


def test_auto_threshold():
    """accel='auto' resolves by primitive count: baked at shipped scale,
    array above ARRAY_AUTO_THRESHOLD. Constructs tracers only (no
    compile)."""
    assert PathTracer(_small("Cornell_Box")).accel == "baked"
    small = stress_scene(ARRAY_AUTO_THRESHOLD - 1)  # +1 plane = threshold
    big = stress_scene(ARRAY_AUTO_THRESHOLD + 64)
    assert PathTracer(small).accel == "baked"
    assert PathTracer(big).accel == "array"


def test_dynamic_array_matches_dynprims():
    """Animated scenes at scale (ArrayDynPrims): runtime pack_scene values
    through the fori sweep + traced light values must be BIT-identical to
    the fully-dynamic DynPrims render at equal (moved) values — on a
    sphere-light stress field and on Cornell (animated triangle lights)."""
    from terminal_raytracer.models.animate import orbit
    from terminal_raytracer.ops.arrayscene import ArrayDynPrims
    from terminal_raytracer.ops.dynamic import pack_scene

    for name in ("stress:48", "Cornell_Box"):
        scene = _small(name)
        arrays = orbit(pack_scene(scene), 5)
        dp = PathTracer(scene, dynamic=True, accel="baked")
        ap = PathTracer(scene, dynamic=True, accel="array")
        assert isinstance(ap.prims, ArrayDynPrims), name
        cd, vd, td, rd = jax.device_get(jax.jit(dp.render_frame_dynamic)(
            POSE, np.uint32(7), np.int32(0), arrays))
        ca, va, ta, ra = jax.device_get(jax.jit(ap.render_frame_dynamic)(
            POSE, np.uint32(7), np.int32(0), arrays))
        assert float(rd) == float(ra), name
        np.testing.assert_array_equal(np.asarray(td), np.asarray(ta), name)
        np.testing.assert_array_equal(np.asarray(vd), np.asarray(va), name)
        np.testing.assert_array_equal(np.asarray(cd.x), np.asarray(ca.x),
                                      name)


def test_dynamic_array_pallas_matches_oracle():
    """The GPU kernel runs the dynamic-array mode (SoA refs + light
    scalars through inputs) and agrees with the ArrayDynPrims oracle."""
    from terminal_raytracer.models.animate import orbit
    from terminal_raytracer.ops.dynamic import pack_scene

    scene = stress_scene(48, seed=3, width=128, height=16,
                         samples_per_pixel=8, max_depth=2)
    arrays = orbit(pack_scene(scene), 5)
    ap = PathTracer(scene, dynamic=True, accel="array")
    co, _vo, to, ro = jax.device_get(jax.jit(ap.render_frame_dynamic)(
        POSE, np.uint32(3), np.int32(0), arrays))
    pf = jax.jit(pallas_kernel.make_render_frame(
        scene, interpret=True, dynamic=True, accel="array"))
    cp, _vp, tp, rp, _occ = jax.device_get(
        pf(POSE, np.uint32(3), np.int32(0), arrays))
    assert float(rp) == float(ro)
    np.testing.assert_array_equal(np.asarray(tp), np.asarray(to))
    np.testing.assert_allclose(np.asarray(cp.x), np.asarray(co.x),
                               atol=2e-5, err_msg="kernel")
