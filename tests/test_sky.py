"""Environment-map sky — capability extension tests.

A scene-level ``sky`` block (models/scene.Sky) replaces the reference's
two-color gradient miss shading (shader.wgsl:297-304) with a texture
sampled by ray direction (ops/tracer.py _sky_radiance): spherical
latitude/longitude uv — the same mapping textured spheres use — fetched
from the shared texel atlas, scaled by a static intensity. Contract:
statically gated (scenes without a sky block compile the exact gradient
program), scene-level only (no per-primitive channel — the traversals are
untouched), and agreeing across the oracle, every Pallas scheduler, and
the dynamic path.
"""

import copy

import jax
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import dynamic as dyn_mod
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer

POSE = Camera().pose()

# Quadrant texture: red/green top half, blue/yellow bottom half (image
# order) — four distinct direction bands.
_QUAD = {"pixels": [
    [[255, 0, 0] if j < 8 else [0, 255, 0] for j in range(16)]
    if i < 8 else
    [[0, 0, 255] if j < 8 else [255, 255, 0] for j in range(16)]
    for i in range(16)
]}
_WHITE = {"pixels": [[[255, 255, 255]] * 4] * 4}


def _sky_scene(**overrides):
    cfg = {
        "width": 64, "height": 16, "samples_per_pixel": 2, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 80.0, "char_aspect_ratio": 1.0},
        "texture_size": 16,
        "textures": {"quad": copy.deepcopy(_QUAD)},
        "sky": {"texture": "quad", "intensity": 1.0},
        "spheres": [], "planes": [],
    }
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


def _render(tracer, seed=42, frame=0):
    return jax.jit(tracer.render_frame)(POSE, np.uint32(seed),
                                        np.int32(frame))


# ---------------------------------------------------------------------------
# Schema / gates
# ---------------------------------------------------------------------------


def test_schema_and_gates():
    s = _sky_scene()
    assert s.has_sky_texture and s.needs_atlas
    assert not s.has_texture  # sky-only: no per-primitive channel
    # The per-primitive texture operands must NOT appear for sky-only
    # scenes (the sky is scene-level static).
    assert not any(k.endswith(("_txi", "_txs"))
                   for k, _ in dyn_mod.scene_keys(s))
    # Short form: "sky": "name".
    s2 = _sky_scene(sky="quad")
    assert s2.sky.texture == "quad" and s2.sky.intensity == 1.0
    plain = load_scene("Cornell_Box")
    assert not plain.has_sky_texture and not plain.needs_atlas


def test_loader_validation():
    with pytest.raises(ValueError, match="nope"):
        _sky_scene(sky="nope")
    with pytest.raises(ValueError, match="intensity"):
        _sky_scene(sky={"texture": "quad", "intensity": 0.0})
    with pytest.raises(ValueError, match="texture"):
        _sky_scene(sky={"intensity": 2.0})
    with pytest.raises(ValueError, match="sky"):
        _sky_scene(sky=3)


def test_atlas_operand_gating():
    # Sky-only scenes must still ride the atlas operand into the kernel;
    # plain scenes must not.
    t = PathTracer(_sky_scene())
    assert t.needs_atlas and not t.has_texture
    assert len(pallas_kernel._table_ops(t)) == 1
    plain = PathTracer(load_scene("Cornell_Box").with_overrides(
        width=32, height=8, samples_per_pixel=1, max_depth=2))
    assert not plain.needs_atlas
    assert pallas_kernel._table_ops(plain) == ()


# ---------------------------------------------------------------------------
# Radiance semantics
# ---------------------------------------------------------------------------


def test_constant_sky_is_exact():
    # An empty scene under a constant white sky: every camera ray misses
    # at depth 0 with attenuation 1. At spp=4 (= the base sample count,
    # max(4, spp/4)) with zero sample variance (no adaptive extras), the
    # spp-normalized frame color is EXACTLY intensity * (255/255).
    scene = _sky_scene(textures={"quad": copy.deepcopy(_WHITE)},
                       sky={"texture": "quad", "intensity": 1.5},
                       samples_per_pixel=4)
    cur, _var, tot, rays = _render(PathTracer(scene))
    # One rounding step survives: XLA may fold the texel unpack scale
    # (1/255) into the intensity multiply (reassociating constants), so
    # 255 * (1/255) * 1.5 lands within 1 ulp of 1.5 — pin to that.
    for ch in (cur.x, cur.y, cur.z):
        a = np.asarray(ch)
        assert (a == a[0, 0]).all()  # spatially constant
        np.testing.assert_allclose(a, 1.5, rtol=2e-7)
    # one ray per sample, all miss immediately
    assert float(rays) == scene.width * scene.height * 4


def test_direction_mapping():
    # The default camera looks along -z: u = 0.5 + atan2(d.z, d.x)/2pi is
    # near 0.25 for every view ray (z<0 dominant), i.e. the LEFT half of
    # the texture (iu < 8) — red above the horizon (v > 0.5), blue below.
    scene = _sky_scene()
    cur, *_ = _render(PathTracer(scene))
    r, g, b = np.asarray(cur.x), np.asarray(cur.y), np.asarray(cur.z)
    assert g.max() == 0.0  # green/yellow quadrants face +z, behind camera
    top, bot = slice(0, 6), slice(10, 16)
    assert (r[top] > 0).all() and (b[top] == 0).all()
    assert (b[bot] > 0).all() and (r[bot] == 0).all()


def test_sky_seen_through_mirror_and_after_bounce():
    # A mirror floor under the quadrant sky: rays bounce down-up, so the
    # mirror region shows sky colors too (the miss branch runs at depth>0
    # with the bounced direction).
    scene = _sky_scene(planes=[{
        "point": [0, -1, 0], "normal": [0, 1, 0],
        "color": [1, 1, 1], "emission": [0, 0, 0], "reflectivity": 1.0,
    }], max_depth=3)
    cur, *_ = _render(PathTracer(scene))
    r = np.asarray(cur.x)
    assert np.isfinite(r).all()
    # the lower image half (floor) reflects the upper sky (red band)
    assert r[12:].max() > 0.0


def test_transports_agree_on_ray_counts():
    # The sky is never NEE-sampled: transport modes change emission
    # weighting, not the miss branch — same RNG chains, same ray counts.
    scene = _sky_scene(planes=[{
        "point": [0, -1, 0], "normal": [0, 1, 0],
        "color": [0.8, 0.8, 0.8], "emission": [0, 0, 0],
        "reflectivity": 0.0,
    }])
    counts = {}
    for transport in ("reference", "unbiased", "mis"):
        *_, rays = _render(PathTracer(scene, transport=transport))
        counts[transport] = float(rays)
    assert len(set(counts.values())) == 1, counts


# ---------------------------------------------------------------------------
# Cross-backend agreement
# ---------------------------------------------------------------------------


def _mixed_scene(**overrides):
    """Sky + textured floor + a light: both atlas fetch paths live."""
    cfg = {
        "width": 128, "height": 8, "samples_per_pixel": 4, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "texture_size": 16,
        "textures": {"quad": copy.deepcopy(_QUAD),
                     "white": copy.deepcopy(_WHITE)},
        "sky": {"texture": "white", "intensity": 0.7},
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [1, 1, 1], "emission": [0, 0, 0],
                    "reflectivity": 0.0,
                    "texture": "quad", "texture_scale": 0.5}],
        "spheres": [{"center": [0, 5, -3], "radius": 1.0,
                     "color": [0, 0, 0], "emission": [10, 10, 10],
                     "reflectivity": 0.0}],
    }
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


def test_recolor_sweep_excludes_sky_only_rows():
    # The hit-recolor fetch sweeps only primitive-referenced texture rows;
    # the sky fetch sweeps only its own (static bounds, gather_texels lo).
    scene = _mixed_scene()
    t = PathTracer(scene)
    assert t.has_texture and t.has_sky
    assert (t.tex_prim_lo, t.tex_prim_hi) == (0, t.tex_rows)  # quad = id 1
    assert t.sky_tid == 2  # white = id 2


def test_pallas_schedulers_match_oracle():
    scene = _mixed_scene()
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


def test_traversals_and_dynamic_agree():
    scene = _mixed_scene(width=64, height=16)
    cur, _var, tot, rays = _render(PathTracer(scene))
    c2, _v2, t2, r2 = _render(PathTracer(scene, accel="array"))
    for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    assert float(r2) == float(rays)
    t_dyn = PathTracer(scene, dynamic=True)
    c3, _v3, t3, r3 = jax.jit(
        lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a)
    )(POSE, np.uint32(42), np.int32(0), dyn_mod.pack_scene(scene))
    for a, b in ((c3.x, cur.x), (c3.y, cur.y), (c3.z, cur.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    assert float(r3) == float(rays)


def test_packaged_envmap_scene():
    scene = load_scene("envmap")
    assert scene.has_sky_texture and not scene.has_texture
    assert scene.sky.texture == "globe" and scene.sky.intensity > 1.0
    small = scene.with_overrides(width=48, height=12, samples_per_pixel=2,
                                 max_depth=2)
    cur, *_ = _render(PathTracer(small))
    arr = np.asarray(cur.x)
    assert np.isfinite(arr).all() and arr.max() > 0.0
