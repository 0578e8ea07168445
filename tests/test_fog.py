"""Volumetric fog (homogeneous participating medium) — extension tests.

models/scene.py `Fog` + ops/tracer.py: scatter distances are sampled
analytically (t = -ln(1-u)/sigma), which importance-samples transmittance
exactly — the path throughput carries no explicit exp() factors; only NEE
shadow segments do. Isotropic phase. Same static-gate contract as the
material extensions: scenes without fog compile to the exact pre-extension
program. The headline correctness test pins Beer-Lambert per pixel against
the closed form.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import scene as sm
from terminal_raytracer.models.scene import Fog
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer

POSE = Camera().pose()

_SCENES = Path(sm.__file__).parent / "scenes"


def _wall_scene(sigma, albedo, spp=4, depth=4, w=64, h=16):
    """Emissive wall at z = -4 behind fog — the Beer-Lambert fixture."""
    return sm.scene_from_dict({
        "width": w, "height": h, "samples_per_pixel": spp,
        "max_depth": depth, "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 40.0, "char_aspect_ratio": 1.0},
        "planes": [{"point": [0, 0, -4], "normal": [0, 0, 1],
                    "color": [0, 0, 0], "emission": [5, 5, 5],
                    "reflectivity": 0.0}],
        "fog": {"density": sigma, "albedo": list(albedo)},
    })


def test_schema_and_validation():
    s = _wall_scene(0.2, (0, 0, 0))
    assert s.has_fog and s.fog.density == pytest.approx(0.2, abs=1e-6)
    assert not load_scene("Cornell_Box").has_fog
    with pytest.raises(ValueError, match="fog density"):
        _wall_scene(0.0, (1, 1, 1))
    with pytest.raises(ValueError, match="fog albedo"):
        _wall_scene(0.2, (-0.1, 1, 1))
    # with_overrides attaches fog to any scene (the CLI --fog path).
    s2 = load_scene("scene2").with_overrides(fog=Fog(density=0.1))
    assert s2.has_fog and s2.fog.albedo == (1.0, 1.0, 1.0)


def _tri_light_fog_scene(g=0.0, albedo=(0.9, 0.9, 0.9), spp=4, depth=5):
    """VERTICAL triangle panel light + diffuse floor in scattering fog —
    pure-diffuse surfaces, so 'mis' and 'unbiased' estimate the same
    integral, on the one light geometry where the reference's NEE
    self-block quirk (t_max measured from the UNOFFSET hit point, which
    'unbiased' deliberately keeps and 'mis' fixes — see direct_light)
    provably cannot fire:

    * sphere lights self-block on rim-grazing samples (the eps origin
      shift moves the near intersection by O(sqrt(eps r)));
    * ANY light surface above a floor self-blocks obliquely — the shadow
      ray crosses the light's own plane at ldist - eps*dot(n,n_l)/
      dot(ldir,n_l) < ldist - eps whenever dot(n - ldir, n_l) < 0;
    * a VERTICAL panel (n_l horizontal) over a horizontal floor has
      dot(n, n_l) = 0: the eps lift moves the origin PARALLEL to the
      light plane, t' = ldist > t_max with the full eps margin — never
      blocked. Volume scatter senders are unoffset and never self-block
      from any geometry.

    Measured before settling on this fixture: the quirk is worth +7-25%
    of the mean with a sphere or overhead-triangle light once fog hides
    the sky that usually dilutes it — a legitimate transport difference,
    not a weight bug."""
    fog = {"density": 0.12, "albedo": list(albedo)}
    if g:
        fog["g"] = g
    return sm.scene_from_dict({
        "width": 32, "height": 16, "samples_per_pixel": spp,
        "max_depth": depth, "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        # x = 5 plane panel; winding chosen so cross(e1, e2) points -x,
        # facing the visible floor region (x < 5).
        "triangles": [{"v0": [5.0, 0.5, -8.0], "v1": [5.0, 0.5, -4.0],
                       "v2": [5.0, 3.5, -6.0], "color": [0, 0, 0],
                       "emission": [8, 8, 8], "reflectivity": 0.0}],
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [0.75, 0.75, 0.75], "emission": [0, 0, 0],
                    "reflectivity": 0.0}],
        "fog": fog,
    })


def test_mis_fog_same_paths_and_mean_matches_unbiased():
    """Fog-aware MIS (round 4 — the former ValueError rejection deleted):
    'mis' reweights only (identical RNG chains/ray counts), and on a
    pure-diffuse fog scene its many-seed mean agrees with 'unbiased'
    (both unbiased estimators of the same transport integral)."""
    from terminal_raytracer.runtime import init_state, make_render_step

    for g in (0.0, 0.6):
        scene = _tri_light_fog_scene(g=g)
        means, rays = {}, {}
        for transport in ("unbiased", "mis"):
            step = make_render_step(scene, backend="jnp",
                                    transport=transport)
            state = init_state(scene)
            for f in range(64):
                out = step(state, POSE,
                           np.uint32((f * 2654435761 + 17) % 2**32),
                           np.int32(f))
                state = out.state
            means[transport] = float(np.asarray(state.acc).mean())
            rays[transport] = float(out.rays)
        assert rays["mis"] == rays["unbiased"]
        rel = abs(means["mis"] - means["unbiased"]) / means["unbiased"]
        assert rel < 0.04, (g, means)


def test_mis_fog_variance_reduction():
    """A huge nearby light through fog: NEE's uniform area sampling is the
    poor strategy (for surfaces AND scatter points); the phase/BSDF lobe
    covers it well. MIS must cut per-pixel sample variance."""
    cfg = {
        "width": 32, "height": 16, "samples_per_pixel": 4, "max_depth": 4,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [{"center": [0, 8.0, -6], "radius": 6.0,
                     "color": [0, 0, 0], "emission": [4, 4, 4],
                     "reflectivity": 0.0}],
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [0.8, 0.8, 0.8], "emission": [0, 0, 0],
                    "reflectivity": 0.0}],
        "fog": {"density": 0.08, "albedo": [0.9, 0.9, 0.9]},
    }
    scene = sm.scene_from_dict(cfg)
    var = {}
    for t in ("unbiased", "mis"):
        cur, v, *_ = jax.jit(
            PathTracer(scene, transport=t).render_frame
        )(POSE, np.uint32(5), np.int32(0))
        assert np.isfinite(np.asarray(cur.x)).all()
        var[t] = float(np.asarray(v).mean())
    assert var["mis"] < var["unbiased"], var


def test_mis_fog_pallas_matches_oracle():
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg.update(width=128, height=8, samples_per_pixel=4, max_depth=4)
    cfg["fog"] = {"density": 0.25, "albedo": [0.85, 0.85, 0.9], "g": 0.5}
    scene = sm.scene_from_dict(cfg)
    cur_o, _vo, tot_o, rays_o = jax.jit(
        PathTracer(scene, transport="mis").render_frame
    )(POSE, np.uint32(42), np.int32(0))
    pf = jax.jit(
        pallas_kernel.make_render_frame(scene, interpret=True,
                                        transport="mis")
    )
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42), np.int32(0))
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y), (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o))
    assert float(rays_p) == float(rays_o)


def test_beer_lambert_per_pixel():
    # Pure absorption (albedo 0): every pixel's expectation is exactly
    # E * exp(-sigma * t_pixel) with t_pixel the analytic camera-ray
    # distance to the wall. The estimator importance-samples the
    # transmittance, so the mean per-pixel ratio must be 1 to within
    # Monte-Carlo error (measured 1.0015 +- 0.0044 at N=96; N=32 here).
    sigma, W, H = 0.2, 64, 16
    scene = _wall_scene(sigma, (0, 0, 0), w=W, h=H)
    tr = PathTracer(scene)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    u = (xs + 0.5) / (W - 1)
    v = ((H - 1) - ys + 0.5) / (H - 1)
    vx = tr.half_width * (2 * u - 1)
    vy = tr.half_height * (2 * v - 1) * tr.inv_char_aspect
    expect = 5.0 * np.exp(-sigma * 4.0 * np.sqrt(1 + vx * vx + vy * vy))

    f = jax.jit(tr.render_frame)
    imgs = []
    for seed in range(8):
        cur, _v_, _t, _r = f(POSE, np.uint32(2000 + 37 * seed), np.int32(0))
        imgs.append(np.asarray(cur.x))
    ratio = np.mean(imgs, axis=0) / expect
    assert abs(float(ratio.mean()) - 1.0) < 0.035, float(ratio.mean())


def test_in_scattering_glow():
    # Pure-scattering fog around a light: camera rays that never point at
    # any surface still pick up radiance via NEE from their scatter
    # points — the glow absorbing fog (albedo 0) cannot produce.
    def render(albedo):
        scene = sm.scene_from_dict({
            "width": 48, "height": 12, "samples_per_pixel": 8,
            "max_depth": 6, "frames_to_accumulate": 1,
            "camera": {"fov_degrees": 50.0, "char_aspect_ratio": 1.0},
            "spheres": [{"center": [0, 3.0, -4], "radius": 0.5,
                         "color": [0, 0, 0], "emission": [20, 20, 20],
                         "reflectivity": 0.0}],
            "fog": {"density": 0.15, "albedo": list(albedo)},
        })
        cur, *_ = jax.jit(PathTracer(scene).render_frame)(
            POSE, np.uint32(11), np.int32(0)
        )
        return np.asarray(cur.x)

    glow = render((1, 1, 1))
    dark = render((0, 0, 0))
    # The bottom half of the frame never sees the light directly.
    assert glow[8:, :].mean() > 5 * max(dark[8:, :].mean(), 1e-6)
    assert np.isfinite(glow).all() and np.isfinite(dark).all()


def test_pallas_schedulers_match_oracle_in_fog():
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg.update(width=128, height=8, samples_per_pixel=4, max_depth=4)
    cfg["fog"] = {"density": 0.25, "albedo": [0.85, 0.85, 0.9]}
    scene = sm.scene_from_dict(cfg)
    cur_o, _vo, tot_o, rays_o = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(42), np.int32(0)
    )
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(
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


def test_fog_composes_with_material_extensions():
    # Fog over the showcase scene (glass + brushed metal + checker):
    # baked and array traversals agree exactly on decisions (fog is
    # scene-global — no traversal involvement at all).
    scene = load_scene("showcase").with_overrides(
        width=48, height=12, samples_per_pixel=4, max_depth=4,
        fog=Fog(density=0.1, albedo=(0.9, 0.9, 0.9)),
    )
    cur, _var, tot, rays = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(5), np.int32(0)
    )
    c2, _v2, t2, r2 = jax.jit(
        PathTracer(scene, accel="array").render_frame
    )(POSE, np.uint32(5), np.int32(0))
    assert float(r2) == float(rays)
    np.testing.assert_array_equal(np.asarray(t2), np.asarray(tot))
    for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    img = np.asarray(cur.x)
    assert np.isfinite(img).all() and img.mean() > 0.005


def test_unbiased_transport_sees_plane_light_through_fog():
    # The emissive wall is a plane — never NEE-sampled — so volume
    # scatter events must keep its emission on their next hit (the
    # light_inv_area == 0 emission gate): with scattering fog the
    # unbiased image glows rather than going black.
    scene = _wall_scene(0.2, (0.8, 0.8, 0.8), spp=16)
    cur, *_ = jax.jit(
        PathTracer(scene, transport="unbiased").render_frame
    )(POSE, np.uint32(7), np.int32(0))
    img = np.asarray(cur.x)
    assert np.isfinite(img).all()
    assert img.mean() > 1.0, img.mean()  # direct survival alone is ~2.1


def test_henyey_greenstein_sampler_and_phase():
    import jax.numpy as jnp

    from terminal_raytracer.ops import rng as prng
    from terminal_raytracer.ops import sampling
    from terminal_raytracer.ops import vecmath as vm
    from terminal_raytracer.ops.vecmath import V3

    n = 8192
    state = prng.seed_pixel(jnp.arange(n, dtype=jnp.uint32), np.uint32(3),
                            np.int32(0))
    d = vm.normalize(V3(jnp.zeros(n) + 0.3, jnp.zeros(n) - 0.5,
                        jnp.zeros(n) + 0.81))
    for g in (0.7, -0.4):
        _s, v = sampling.henyey_greenstein_dir(state, d, g)
        cos = np.asarray(vm.dot(v, d))
        # E[cos theta] = g is THE defining property of HG.
        assert abs(cos.mean() - g) < 0.02, (g, cos.mean())
        np.testing.assert_allclose(np.asarray(vm.length(v)), 1.0,
                                   atol=1e-5)
    # The phase function must integrate to 1 over the sphere.
    mu = np.linspace(-1, 1, 20001)
    for g in (0.7, -0.4):
        ph = np.asarray(sampling.hg_phase(jnp.asarray(mu, jnp.float32), g))
        integral = float(np.trapezoid(ph * 2 * np.pi, mu))
        assert abs(integral - 1.0) < 1e-3, (g, integral)


def test_anisotropy_changes_the_image_and_validates():
    base = {
        "width": 48, "height": 12, "samples_per_pixel": 8, "max_depth": 6,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 50.0, "char_aspect_ratio": 1.0},
        "spheres": [{"center": [0, 3.0, -4], "radius": 0.5,
                     "color": [0, 0, 0], "emission": [20, 20, 20],
                     "reflectivity": 0.0}],
    }
    iso = sm.scene_from_dict({**base, "fog": {"density": 0.15}})
    fwd = sm.scene_from_dict({**base, "fog": {"density": 0.15, "g": 0.7}})
    assert iso.fog.g == 0.0  # absent key -> isotropic (the g=0 bit-exact path)
    c0, *_ = jax.jit(PathTracer(iso).render_frame)(
        POSE, np.uint32(11), np.int32(0)
    )
    cg, *_ = jax.jit(PathTracer(fwd).render_frame)(
        POSE, np.uint32(11), np.int32(0)
    )
    i0, ig = np.asarray(c0.x), np.asarray(cg.x)
    assert np.isfinite(ig).all()
    assert not np.array_equal(i0, ig)
    with pytest.raises(ValueError, match="anisotropy"):
        sm.scene_from_dict({**base, "fog": {"density": 0.1, "g": 1.0}})


def test_anisotropic_fog_pallas_matches_oracle():
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg.update(width=128, height=8, samples_per_pixel=4, max_depth=4)
    cfg["fog"] = {"density": 0.25, "albedo": [0.85, 0.85, 0.9], "g": 0.6}
    scene = sm.scene_from_dict(cfg)
    cur_o, _vo, tot_o, rays_o = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(42), np.int32(0)
    )
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42), np.int32(0))
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y), (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o))
    assert float(rays_p) == float(rays_o)


def test_absorbing_fog_black_paths_stay_finite():
    # albedo (0,0,0) zeroes att on every scatter event; Russian roulette
    # must kill those lanes decisively (p_surv == 0) — never divide 0/0.
    scene = _wall_scene(0.3, (0, 0, 0), spp=8, depth=16)
    cur, *_ = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(13), np.int32(0)
    )
    img = np.asarray(cur.x)
    assert np.isfinite(img).all()
