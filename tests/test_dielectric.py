"""Dielectric (glass) materials — capability extension tests.

The reference has no refractive materials (its BSDF is stochastic
mirror-or-Lambert, reference: src/shader.wgsl:465-480); `transparency` /
`ior` are schema-superset Material fields (models/scene.py). The contract
under test:

* scenes WITHOUT dielectrics compile to the exact pre-extension program
  (no extra ops, RNG draws, or operand-layout changes) — the glass branch
  is statically gated;
* scenes WITH dielectrics agree bit-for-bit across every traversal
  (baked / array / dynamic / grid) and across the jnp oracle and the GPU
  kernel (decision outputs exact, radiance to float fusion);
* the refraction math obeys Snell's law, total internal reflection, and
  Schlick's normal-incidence reflectance.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import dynamic as dyn_mod
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops import rng as prng
from terminal_raytracer.ops import vecmath as vm
from terminal_raytracer.ops.tracer import (
    PathTracer, fresnel_schlick, refract,
)
from terminal_raytracer.ops.vecmath import V3

POSE = Camera().pose()

_SCENES = Path(sm.__file__).parent / "scenes"


def _glass_cornell(**overrides):
    """Cornell Box with the small matte sphere turned to glass."""
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["spheres"][1].update(
        transparency=0.95, ior=1.5, color=[1.0, 1.0, 1.0]
    )
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def test_material_defaults_are_reference_exact():
    m = sm.Material(color=(1, 1, 1), emission=(0, 0, 0), reflectivity=0.3)
    assert m.transparency == 0.0 and m.ior == 1.5
    assert not m.is_dielectric
    assert not load_scene("Cornell_Box").has_dielectrics


def test_json_fields_parse_and_narrow():
    s = _glass_cornell()
    m = s.spheres[1].material
    assert m.transparency == float(np.float32(0.95))
    assert m.ior == 1.5
    assert m.is_dielectric and s.has_dielectrics


def test_validation():
    base = dict(
        width=10, height=5, samples_per_pixel=1, max_depth=1,
        frames_to_accumulate=1,
        camera={"fov_degrees": 45.0, "char_aspect_ratio": 0.55},
    )

    def sphere(**mat):
        d = {"center": [0, 0, -3], "radius": 1.0, "color": [1, 1, 1],
             "emission": [0, 0, 0], "reflectivity": 0.0}
        d.update(mat)
        return sm.scene_from_dict({**base, "spheres": [d]})

    sphere(transparency=1.0)  # ok
    sphere(transparency=0.5, reflectivity=0.5)  # ok: probabilities sum to 1
    with pytest.raises(ValueError, match="transparency"):
        sphere(transparency=1.5)
    with pytest.raises(ValueError, match="transparency"):
        sphere(transparency=-0.1)
    with pytest.raises(ValueError, match="ior"):
        sphere(transparency=0.5, ior=0.0)
    with pytest.raises(ValueError, match="reflectivity"):
        sphere(transparency=0.6, reflectivity=0.6)
    sphere(transparency=0.0, ior=0.0)  # ior unchecked when not dielectric


def test_operand_layout_unchanged_without_dielectrics():
    # The dynamic/array operand layouts gain transp/ior keys ONLY for
    # scenes that have dielectrics — reference scenes keep their exact
    # pre-extension layouts (compiled-signature stability).
    plain = load_scene("Cornell_Box")
    glass = _glass_cornell()
    plain_keys = {k for k, _ in dyn_mod.scene_keys(plain)}
    glass_keys = {k for k, _ in dyn_mod.scene_keys(glass)}
    assert not any(k.endswith(("_transp", "_ior")) for k in plain_keys)
    assert {"s_transp", "s_ior", "p_transp", "p_ior",
            "t_transp", "t_ior"} <= glass_keys


# ---------------------------------------------------------------------------
# Refraction math (unit level)
# ---------------------------------------------------------------------------


def test_snells_law():
    # Incident 45 degrees onto a glass half-space (eta = 1/1.5).
    n = V3(jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0))
    s = float(np.sin(np.radians(45.0)))
    c = float(np.cos(np.radians(45.0)))
    d = V3(jnp.float32(s), jnp.float32(-c), jnp.float32(0.0))
    eta = jnp.float32(1.0 / 1.5)
    t_dir, cos_i, cos_t, tir = refract(d, n, eta)
    assert not bool(tir)
    assert float(cos_t) == pytest.approx(
        float(np.sqrt(1.0 - (float(eta) * s) ** 2)), abs=1e-6
    )
    assert float(cos_i) == pytest.approx(c, abs=1e-6)
    # sin(theta_t) = eta * sin(theta_i); direction stays in the x/y plane
    # and keeps its transverse orientation.
    sin_t = float(t_dir.x)
    assert sin_t == pytest.approx(float(eta) * s, abs=1e-6)
    assert float(t_dir.z) == 0.0
    assert float(t_dir.y) < 0.0  # continues into the surface
    norm = float(vm.length(t_dir))
    assert norm == pytest.approx(1.0, abs=1e-6)


def test_eta_one_is_identity():
    n = V3(jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0))
    d = vm.normalize(V3(jnp.float32(0.3), jnp.float32(-0.8),
                        jnp.float32(0.5)))
    t_dir, _cos_i, _cos_t, tir = refract(d, n, jnp.float32(1.0))
    assert not bool(tir)
    for a, b in ((t_dir.x, d.x), (t_dir.y, d.y), (t_dir.z, d.z)):
        assert float(a) == pytest.approx(float(b), abs=1e-6)


def test_total_internal_reflection_condition():
    # Inside glass (eta = 1.5), the critical angle is asin(1/1.5) = 41.8
    # degrees: 40 degrees refracts, 45 degrees is TIR.
    n = V3(jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0))
    eta = jnp.float32(1.5)
    for deg, expect_tir in ((40.0, False), (45.0, True)):
        s = float(np.sin(np.radians(deg)))
        c = float(np.cos(np.radians(deg)))
        d = V3(jnp.float32(s), jnp.float32(-c), jnp.float32(0.0))
        _t, _ci, _ct, tir = refract(d, n, eta)
        assert bool(tir) == expect_tir, deg


def test_schlick_normal_incidence():
    # r0 = ((1 - n)/(1 + n))^2 = 0.04 for n = 1.5, same from either side.
    for eta in (1.5, 1.0 / 1.5):
        r = float(fresnel_schlick(jnp.float32(1.0), jnp.float32(eta)))
        assert r == pytest.approx(0.04, abs=1e-3)
    # Grazing incidence reflects everything.
    assert float(fresnel_schlick(jnp.float32(0.0), jnp.float32(1.5))
                 ) == pytest.approx(1.0, abs=1e-6)


def test_schlick_exit_side_uses_transmitted_cosine():
    # Exiting a denser medium (eta = 1.5), Schlick's (1-cos)^5 term must
    # use cos_t, not cos_i: at 40 deg (just below the 41.8 deg critical
    # angle) exact unpolarized Fresnel is ~0.25-0.3; cos_i would give
    # ~0.04 and then snap discontinuously to 1 at TIR.
    n = V3(jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0))
    eta = jnp.float32(1.5)
    s = float(np.sin(np.radians(40.0)))
    c = float(np.cos(np.radians(40.0)))
    d = V3(jnp.float32(s), jnp.float32(-c), jnp.float32(0.0))
    _t, cos_i, cos_t, tir = refract(d, n, eta)
    assert not bool(tir)
    fres = float(fresnel_schlick(
        jnp.where(eta > 1.0, cos_t, cos_i), eta
    ))
    assert fres == pytest.approx(0.243, abs=0.03)
    # Continuity at the critical angle: cos_t -> 0 drives fres -> 1
    # (0.72 at 41.7 deg, rising monotonically to 1.0 at 41.81 deg; the
    # incident-cosine bug would sit at ~0.04 here and jump to 1 at TIR).
    s_c = float(np.sin(np.radians(41.7)))
    c_c = float(np.cos(np.radians(41.7)))
    d_c = V3(jnp.float32(s_c), jnp.float32(-c_c), jnp.float32(0.0))
    _t2, _ci2, cos_t2, tir2 = refract(d_c, n, eta)
    assert not bool(tir2)
    assert float(fresnel_schlick(cos_t2, eta)) > 0.7


def test_tir_bounce_is_deterministic_reflection():
    # A ray inside a glass sphere beyond the critical angle MUST reflect
    # (no RNG outcome can refract it) — drive one bounce_step end-to-end.
    cfg = {
        "width": 4, "height": 4, "samples_per_pixel": 4, "max_depth": 4,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 0.55},
        "spheres": [{"center": [0, 0, 0], "radius": 1.0,
                     "color": [1, 1, 1], "emission": [0, 0, 0],
                     "reflectivity": 0.0, "transparency": 1.0,
                     "ior": 1.5}],
    }
    tracer = PathTracer(sm.scene_from_dict(cfg))
    lanes = jnp.zeros((4,), jnp.float32)
    o = V3(lanes + 0.8, lanes, lanes)
    d = V3(lanes, lanes + 1.0, lanes)  # hits at (0.8, 0.6, 0): 53 deg > 42
    state = prng.seed_pixel(
        jnp.zeros((4,), jnp.uint32), np.uint32(7), np.int32(0)
    )
    alive = jnp.ones((4,), bool)
    ones = vm.splat(lanes + 1.0)
    zero3 = vm.splat(lanes)

    def step(state):
        return tracer.bounce_step(
            state, o, d, ones, zero3, alive, jnp.int32(0), lanes,
            lanes + tracer._emit_fresh,
        )

    _, _o2, d2, _att, _acc, alive2, _rays, _ = jax.jit(step)(state)
    assert bool(jnp.all(alive2))
    expect = np.array([-0.96, 0.28, 0.0], np.float32)  # reflect about n
    got = np.stack([np.asarray(d2.x), np.asarray(d2.y), np.asarray(d2.z)])
    np.testing.assert_allclose(got, expect[:, None].repeat(4, 1), atol=1e-6)


# ---------------------------------------------------------------------------
# Traversal / scheduler agreement
# ---------------------------------------------------------------------------


def _render(tracer, seed=42, frame=0):
    return jax.jit(tracer.render_frame)(POSE, np.uint32(seed),
                                        np.int32(frame))


def test_traversals_bit_identical_on_glass_scene():
    scene = _glass_cornell(width=64, height=16, samples_per_pixel=4,
                           max_depth=6)
    cur, var, tot, rays = _render(PathTracer(scene))
    for accel in ("array", "grid"):
        c2, v2, t2, r2 = _render(PathTracer(scene, accel=accel))
        for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z),
                     (v2, var), (t2, tot)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=accel)
        assert float(r2) == float(rays), accel
    # Dynamic traversal at template values.
    t_dyn = PathTracer(scene, dynamic=True)
    c3, v3, t3, r3 = jax.jit(
        lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a)
    )(POSE, np.uint32(42), np.int32(0), dyn_mod.pack_scene(scene))
    for a, b in ((c3.x, cur.x), (c3.y, cur.y), (c3.z, cur.z)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(r3) == float(rays)


def test_pallas_schedulers_match_oracle_on_glass_scene():
    scene = _glass_cornell(width=128, height=8, samples_per_pixel=4,
                           max_depth=4)
    cur_o, var_o, tot_o, rays_o = _render(PathTracer(scene))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, var_p, tot_p, rays_p, _occ = pf(
        POSE, np.uint32(42), np.int32(0)
    )
    err = "kernel"
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y),
                 (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, err_msg=err)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o),
                                  err)
    assert float(rays_p) == float(rays_o), err


# ---------------------------------------------------------------------------
# Physics / image-level behavior
# ---------------------------------------------------------------------------


def test_glass_transmits_opaque_blocks():
    # An emissive wall behind a sphere: an ior=1 clear-glass sphere passes
    # the wall's radiance straight through (no bending, ~0 Fresnel at
    # normal incidence); an opaque black sphere blocks it.
    base = {
        "width": 32, "height": 16, "samples_per_pixel": 4, "max_depth": 4,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 1.0},
        "planes": [{"point": [0, 0, -5], "normal": [0, 0, 1],
                    "color": [0, 0, 0], "emission": [5, 5, 5],
                    "reflectivity": 0.0}],
    }
    sphere = {"center": [0, 0, -2], "radius": 0.5, "color": [1, 1, 1],
              "emission": [0, 0, 0], "reflectivity": 0.0}

    def center_lum(scene):
        cur, *_ = _render(PathTracer(scene))
        h, w = scene.height // 2, scene.width // 2
        return float(np.asarray(cur.x)[h, w])

    glass = sm.scene_from_dict(
        {**base, "spheres": [{**sphere, "transparency": 1.0, "ior": 1.0}]}
    )
    opaque = sm.scene_from_dict(
        {**base, "spheres": [{**sphere, "color": [0, 0, 0]}]}
    )
    assert center_lum(glass) > 2.0
    assert center_lum(opaque) < 0.5


def test_packaged_cornell_glass_scene():
    scene = load_scene("cornell_glass")
    assert scene.has_dielectrics
    assert [s.material.transparency for s in scene.spheres] == [
        0.0, float(np.float32(0.95)), 0.0, 1.0
    ]
    small = scene.with_overrides(width=48, height=12, samples_per_pixel=4,
                                 max_depth=4)
    cur, _var, _tot, rays = _render(PathTracer(small))
    img = np.stack([np.asarray(cur.x), np.asarray(cur.y),
                    np.asarray(cur.z)], -1)
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert float(rays) > 0


def test_mis_transport_runs_on_glass_scene():
    # MIS treats the glass branch as a delta lobe (full-weight emission on
    # its hits; NEE weighted by the diffuse-only selection probability).
    scene = _glass_cornell(width=48, height=12, samples_per_pixel=4,
                           max_depth=4)
    for transport in ("reference", "unbiased", "mis"):
        cur, *_rest = _render(PathTracer(scene, transport=transport))
        img = np.asarray(cur.x)
        assert np.isfinite(img).all() and img.mean() > 0.01, transport


def test_pallas_grid_glass_matches_oracle():
    # The one traversal x backend combination nothing else executes: the
    # blocked-order grid sweep inside the GPU kernel with the glass branch
    # live. Both sides sweep the same blocked order densely, so
    # rays/budgets are exactly equal to the jnp oracle.
    from terminal_raytracer.runtime import init_state, make_render_step

    scene = _glass_cornell(width=64, height=16, samples_per_pixel=4,
                           max_depth=4)
    step_j = make_render_step(scene, backend="jnp", accel="grid")
    step_p = make_render_step(scene, backend="pallas", accel="grid",
                              interpret=True)
    a = step_j(init_state(scene), POSE, np.uint32(9), np.int32(0))
    b = step_p(init_state(scene), POSE, np.uint32(9), np.int32(0))
    assert float(a.rays) == float(b.rays)
    np.testing.assert_allclose(
        np.asarray(a.state.acc), np.asarray(b.state.acc),
        rtol=2e-3, atol=1e-5,
    )
    np.testing.assert_array_equal(
        np.asarray(a.state.samples), np.asarray(b.state.samples)
    )


def test_glass_gets_no_lambertian_nee_ghost():
    # A transparency=1 sphere must accumulate NO diffuse direct light in
    # any transport (the reference's full-Lambert NEE quirk is kept on
    # mirrors for parity, but glass has no reference counterpart).
    # One bounce on a glass sphere under a bright NEE light: acc stays 0
    # (emission=0 on the sphere, NEE scaled by 1 - transparency = 0).
    cfg = {
        "width": 4, "height": 4, "samples_per_pixel": 4, "max_depth": 4,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 0.55},
        "spheres": [
            {"center": [0, 0, -3], "radius": 1.0, "color": [1, 1, 1],
             "emission": [0, 0, 0], "reflectivity": 0.0,
             "transparency": 1.0, "ior": 1.5},
            {"center": [0, 3, -3], "radius": 0.5, "color": [1, 1, 1],
             "emission": [50, 50, 50], "reflectivity": 0.0},
        ],
    }
    tracer = PathTracer(sm.scene_from_dict(cfg))
    lanes = jnp.zeros((4,), jnp.float32)
    o = vm.splat(lanes)
    d = V3(lanes, lanes, lanes - 1.0)  # straight at the glass sphere
    state = prng.seed_pixel(
        jnp.zeros((4,), jnp.uint32), np.uint32(3), np.int32(0)
    )
    alive = jnp.ones((4,), bool)

    def step(state):
        return tracer.bounce_step(
            state, o, d, vm.splat(lanes + 1.0), vm.splat(lanes), alive,
            jnp.int32(0), lanes, lanes + tracer._emit_fresh,
        )

    _, _o2, _d2, _att, acc, _alive, _rays, _ = jax.jit(step)(state)
    for ch in (acc.x, acc.y, acc.z):
        np.testing.assert_array_equal(np.asarray(ch), 0.0)


def test_sharded_step_matches_single_chip_on_glass():
    # The multi-chip ('px') sharded step over a glass scene: pixel-row DP
    # changes no estimator, so it must equal the single-chip render
    # bit-for-bit — including through the dielectric branch.
    from terminal_raytracer.parallel import (
        make_mesh, make_sharded_render_step,
    )
    from terminal_raytracer.runtime import init_state, make_render_step

    scene = _glass_cornell(width=64, height=32, samples_per_pixel=4,
                           max_depth=4)
    mesh = make_mesh(n_px=4, n_sp=1)
    step, mk_state = make_sharded_render_step(scene, mesh, backend="jnp")
    out = step(mk_state(), POSE, np.uint32(5), np.int32(0))
    ref = make_render_step(scene, backend="jnp")(
        init_state(scene), POSE, np.uint32(5), np.int32(0)
    )
    np.testing.assert_allclose(
        np.asarray(out.state.acc), np.asarray(ref.state.acc), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(out.rgb), np.asarray(ref.rgb))
    assert float(out.rays) == float(ref.rays)


def test_dynamic_array_sweep_with_glass():
    # Dielectrics through ArrayDynPrims (dynamic values AND O(1) sweep
    # code): the glass operand keys ride the SoA refs. At template values
    # the render must equal the fully-baked tracer bit-for-bit.
    scene = _glass_cornell(width=48, height=12, samples_per_pixel=4,
                           max_depth=4)
    t_base = PathTracer(scene)
    cur, _var, _tot, rays = _render(t_base)
    t_dyn = PathTracer(scene, dynamic=True, accel="array")
    from terminal_raytracer.ops.arrayscene import ArrayDynPrims

    assert isinstance(t_dyn.prims, ArrayDynPrims)
    c2, _v2, _t2, r2 = jax.jit(
        lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a)
    )(POSE, np.uint32(42), np.int32(0), dyn_mod.pack_scene(scene))
    for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(r2) == float(rays)


def test_render_step_pipeline_with_glass():
    # Full runtime step (tonemap + uint8 framing) on the packaged scene.
    from terminal_raytracer.runtime import init_state, make_render_step

    scene = load_scene("cornell_glass").with_overrides(
        width=48, height=12, samples_per_pixel=4, max_depth=4
    )
    step = make_render_step(scene, full_color=True, backend="jnp")
    out = step(init_state(scene), POSE, np.uint32(3), np.int32(0))
    rgb = np.asarray(out.rgb)
    assert rgb.dtype == np.uint8 and rgb.shape == (12, 48, 3)
    assert rgb.max() > 0
