"""Metal roughness (fuzzy mirror) — capability extension tests.

`roughness` fuzzes the mirror branch: reflect + roughness * uniform-sphere
vector, re-normalized; a fuzzed direction at/below the surface absorbs the
path. The reference's BSDF has no such lobe, but its dead
`random_in_unit_sphere` (reference: src/shader.wgsl:117-124) gestures at
exactly this feature. Contract mirrors the dielectric extension
(test_dielectric): statically gated (scenes without roughness compile to
the exact pre-extension program), agreeing across every traversal and
scheduler — exactly for all decision outputs (rays, budgets), bitwise for
radiance except the documented XLA-CPU FMA-contraction ulp (ops/arrayscene
`_fori`).
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.models import Camera
from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import dynamic as dyn_mod
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops import rng as prng
from terminal_raytracer.ops import sampling
from terminal_raytracer.ops import vecmath as vm
from terminal_raytracer.ops.tracer import PathTracer
from terminal_raytracer.ops.vecmath import V3

POSE = Camera().pose()

_SCENES = Path(sm.__file__).parent / "scenes"


def _rough_cornell(rough=0.3, **overrides):
    """Cornell Box with the mirror sphere brushed."""
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["spheres"][2]["roughness"] = rough
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


def _render(tracer, seed=42, frame=0):
    return jax.jit(tracer.render_frame)(POSE, np.uint32(seed),
                                        np.int32(frame))


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


def test_schema_and_static_gate():
    m = sm.Material(color=(1, 1, 1), emission=(0, 0, 0), reflectivity=1.0)
    assert m.roughness == 0.0 and not m.is_rough
    s = _rough_cornell(0.25)
    assert s.spheres[2].material.roughness == 0.25
    assert s.has_rough_metals and not s.has_dielectrics
    # Operand layout gains the rough keys only for scenes that have them.
    plain = sm.scene_from_dict(
        json.loads((_SCENES / "Cornell_Box.json").read_text())
    )
    assert not any(k.endswith("_rough")
                   for k, _ in dyn_mod.scene_keys(plain))
    assert {"s_rough", "p_rough", "t_rough"} <= {
        k for k, _ in dyn_mod.scene_keys(s)
    }


def test_validation():
    with pytest.raises(ValueError, match="roughness"):
        _rough_cornell(1.5)
    with pytest.raises(ValueError, match="roughness"):
        _rough_cornell(-0.1)
    _rough_cornell(1.0)  # boundary ok


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------


def test_uniform_sphere_dir_distribution():
    n = 4096
    state = prng.seed_pixel(
        jnp.arange(n, dtype=jnp.uint32), np.uint32(11), np.int32(0)
    )
    _state, v = sampling.uniform_sphere_dir(state)
    x, y, z = (np.asarray(c) for c in (v.x, v.y, v.z))
    norms = np.sqrt(x * x + y * y + z * z)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    # Uniform on the sphere: component means ~ 0 (sd of the mean ~ 0.009).
    for c in (x, y, z):
        assert abs(c.mean()) < 0.05
    # Both hemispheres populated in z (cos is uniform in [-1, 1]).
    assert (z > 0.5).mean() > 0.15 and (z < -0.5).mean() > 0.15


def test_fuzz_pdf_matches_sampler_and_normalizes():
    """sampling.fuzz_pdf is the analytic solid-angle pdf of the fuzz lobe
    normalize(R + f*S): pinned three ways per roughness — (a) an
    INDEPENDENT numpy reconstruction of the lobe's cos-to-axis histogram
    matches the closed-form bin masses F(b) = b*sqrt(b^2-c)/f; (b) fine
    quadrature of fuzz_pdf reproduces the same masses (so the jnp code IS
    that closed form); (c) the pdf integrates to 1 (no leaked or invented
    probability for the mis balance weights to mis-split)."""
    gen = np.random.default_rng(3)
    n = 200_000
    for f in (0.3, 0.75, 1.0):
        z = 1.0 - 2.0 * gen.random(n)
        phi = 2.0 * np.pi * gen.random(n)
        s = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        p = np.stack([f * s * np.cos(phi), f * s * np.sin(phi), 1.0 + f * z],
                     axis=1)
        b = p[:, 2] / np.linalg.norm(p, axis=1)  # cos to the +z axis
        c = 1.0 - f * f
        lo = np.sqrt(max(c, 0.0))
        assert (b < lo - 1e-5).mean() == 0.0  # nothing outside the cone
        edges = np.linspace(lo, 1.0, 13)
        got = np.histogram(b, bins=edges)[0] / n

        def F(x):
            return x * np.sqrt(np.maximum(x * x - c, 0.0)) / f

        closed = F(edges[1:]) - F(edges[:-1])
        np.testing.assert_allclose(got, closed, atol=4e-3)
        # (b) marginal quadrature of the jnp pdf: mass(bin) = int 2*pi*p db
        fine = np.linspace(lo, 1.0, 12 * 400 + 1)
        mid = 0.5 * (fine[1:] + fine[:-1])
        pdf = np.asarray(sampling.fuzz_pdf(jnp.asarray(mid, jnp.float32),
                                           jnp.float32(f)))
        mass = 2.0 * np.pi * pdf * np.diff(fine)
        quad = mass.reshape(12, 400).sum(axis=1)
        # The floored edge singularity under-integrates its bin slightly;
        # everywhere else the quadrature matches the closed form tightly.
        np.testing.assert_allclose(quad[1:], closed[1:], rtol=2e-3)
        assert abs(quad.sum() - 1.0) < 2e-2, (f, quad.sum())
    # roughness == 0 (delta lobe) and out-of-cone directions report 0.
    z = np.asarray(sampling.fuzz_pdf(jnp.asarray([1.0, 0.99, 0.5]),
                                     jnp.asarray([0.0, 0.3, 0.3])))
    assert z[0] == 0.0 and z[2] == 0.0 and z[1] > 0.0


# ---------------------------------------------------------------------------
# Scatter semantics
# ---------------------------------------------------------------------------


def test_fuzz_blurs_the_mirror():
    # Same scene/seed, roughness 0 vs 0.5: the mirror sphere's reflected
    # image must change, everything stays finite, and diffuse-only pixels
    # (the first bounce off a wall never takes the mirror branch... but
    # subsequent bounces can reach the sphere) keep the same ray budget
    # structure. The strongest cheap signal: the images differ exactly
    # where paths touched the fuzzy sphere.
    kw = dict(width=64, height=16, samples_per_pixel=4, max_depth=4)
    sharp = _rough_cornell(0.0, **kw)
    fuzzy = _rough_cornell(0.5, **kw)
    assert not sharp.has_rough_metals  # rough=0 parses back to the gate off
    c0, *_ = _render(PathTracer(sharp))
    c1, *_ = _render(PathTracer(fuzzy))
    a = np.stack([np.asarray(c0.x), np.asarray(c0.y), np.asarray(c0.z)], -1)
    b = np.stack([np.asarray(c1.x), np.asarray(c1.y), np.asarray(c1.z)], -1)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    assert not np.array_equal(a, b)
    # Overall brightness stays in the same regime (fuzz redirects, it
    # doesn't create energy; absorption only removes a little).
    assert 0.3 < b.mean() / a.mean() <= 1.1


def test_below_surface_absorption():
    # Grazing reflection off a roughness=1 mirror plane: the fuzzed
    # direction lands below the surface for ~half the lanes — those paths
    # must die (alive=False), with no NaNs anywhere.
    cfg = {
        "width": 4, "height": 4, "samples_per_pixel": 4, "max_depth": 4,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 0.55},
        "planes": [{"point": [0, 0, 0], "normal": [0, 1, 0],
                    "color": [1, 1, 1], "emission": [0, 0, 0],
                    "reflectivity": 1.0, "roughness": 1.0}],
    }
    tracer = PathTracer(sm.scene_from_dict(cfg))
    n = 256
    lanes = jnp.zeros((n,), jnp.float32)
    o = V3(lanes, lanes + 0.1, lanes)
    # Nearly grazing: mostly +x, slightly down.
    d = vm.normalize(V3(lanes + 1.0, lanes - 0.02, lanes))
    state = prng.seed_pixel(
        jnp.arange(n, dtype=jnp.uint32), np.uint32(5), np.int32(0)
    )
    alive = jnp.ones((n,), bool)

    def step(state):
        return tracer.bounce_step(
            state, o, d, vm.splat(lanes + 1.0), vm.splat(lanes), alive,
            jnp.int32(0), lanes, lanes + tracer._emit_fresh,
        )

    _, o2, d2, att, acc, alive2, _rays, _ = jax.jit(step)(state)
    alive2 = np.asarray(alive2)
    frac = alive2.mean()
    assert 0.2 < frac < 0.8, frac  # ~half absorbed at grazing incidence
    for comp in (d2.x, d2.y, d2.z, att.x, acc.x):
        assert np.isfinite(np.asarray(comp)).all()
    # Survivors scatter above the surface.
    up = np.asarray(vm.dot(d2, V3(0.0, 1.0, 0.0)))
    assert (up[alive2] > 0).all()


# ---------------------------------------------------------------------------
# Traversal / scheduler agreement
# ---------------------------------------------------------------------------


def test_traversals_agree_on_rough_scene():
    scene = _rough_cornell(0.3, width=64, height=16, samples_per_pixel=4,
                           max_depth=4)
    cur, var, tot, rays = _render(PathTracer(scene))
    for accel in ("array", "grid"):
        c2, v2, t2, r2 = _render(PathTracer(scene, accel=accel))
        for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z),
                     (v2, var)):
            if accel == "array":
                # XLA-CPU FMA contraction can differ between the fori
                # sweep body and unrolled code by 1 ulp on isolated
                # pixels (documented: ops/arrayscene.py _fori; the mesh
                # tests pin the same contract), amplified through the
                # variance's E[x^2]-E[x]^2 cancellation (observed: one
                # pixel, 7e-7 relative). Decisions stay exact below.
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=accel)
            else:
                np.testing.assert_array_equal(np.asarray(a),
                                              np.asarray(b), err_msg=accel)
        np.testing.assert_array_equal(np.asarray(t2), np.asarray(tot),
                                      err_msg=accel)
        assert float(r2) == float(rays), accel
    t_dyn = PathTracer(scene, dynamic=True)
    c3, _v3, t3, r3 = jax.jit(
        lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a)
    )(POSE, np.uint32(42), np.int32(0), dyn_mod.pack_scene(scene))
    for a, b in ((c3.x, cur.x), (c3.y, cur.y), (c3.z, cur.z)):
        # Same XLA-CPU FMA-contraction caveat as the array sweep (this
        # scene lands on 1 ulp in one pixel); decisions stay exact.
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(t3), np.asarray(tot))
    assert float(r3) == float(rays)


def test_pallas_schedulers_match_oracle_on_rough_glass_scene():
    # Roughness AND glass live together (independent static gates, fixed
    # canonical draw order: branch-select, fuzz pair, Fresnel, cosine).
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg["spheres"][2]["roughness"] = 0.3
    cfg["spheres"][1].update(transparency=0.95, ior=1.5, color=[1, 1, 1])
    cfg.update(width=128, height=8, samples_per_pixel=4, max_depth=4)
    scene = sm.scene_from_dict(cfg)
    assert scene.has_rough_metals and scene.has_dielectrics
    cur_o, _var_o, tot_o, rays_o = _render(PathTracer(scene))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _var_p, tot_p, rays_p, _occ = pf(
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
