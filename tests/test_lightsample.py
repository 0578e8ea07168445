"""Single-light NEE sampling (`light_sample: uniform|power`) — extension
tests.

models/scene.py `light_sample` + ops/tracer.py `_one_light_nee`: instead of
the reference's one-shadow-ray-per-light NEE loop (shader.wgsl:338-436,
per-bounce occlusion cost O(L) primitive sweeps), each lane picks ONE light
(uniformly or proportional to emitted power) and weights the single
estimate by 1/p(pick) — same expectation, O(1) occlusion cost. Scene-level
static like `sampler`: 'all' (default) compiles the exact reference
program; scenes with <= 1 NEE light normalize to 'all'.

The unbiasedness fixtures keep every light DIM enough that no contribution
reaches the NEE firefly clamp (10.0) even after the 1/p(pick) scaling —
the clamp binds the two estimators at different thresholds, so a clamped
fixture would measure clamp bias, not sampling bias.
"""

import numpy as np
import pytest

import jax

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.dynamic import pack_scene
from terminal_raytracer.ops.tracer import PathTracer

POSE = Camera().pose()


def _tri_light(apex, power, half=0.8):
    """A vertical emissive triangle panel at `apex` (mixed-kind fixture)."""
    x, y, z = apex
    return {"v0": [x - half, y - half, z], "v1": [x + half, y - half, z],
            "v2": [x, y + half, z], "color": [0, 0, 0],
            "emission": [power, power, power], "reflectivity": 0.0}


def _multi_scene(powers=(6.0, 1.5, 0.4), light_sample="all", tri=False,
                 spp=4, depth=4, w=48, h=12, **extra):
    """Floor + two diffuse spheres lit by len(powers) small sphere lights
    (or, tri=True, the last one a vertical triangle panel). Dim enough
    that no NEE contribution clamps under any mode's 1/p scaling."""
    lights = []
    for i, p in enumerate(powers):
        pos = [-3.0 + 3.0 * i, 3.5 + 0.5 * (i % 2), -6.0 - 1.5 * i]
        if tri and i == len(powers) - 1:
            lights.append(("tri", _tri_light(pos, p)))
        else:
            lights.append(("sph", {
                "center": pos, "radius": 0.5, "color": [1, 1, 1],
                "emission": [p, p, p], "reflectivity": 0.0}))
    cfg = {
        "width": w, "height": h, "samples_per_pixel": spp,
        "max_depth": depth, "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 55.0, "char_aspect_ratio": 1.0},
        "spheres": [l for k, l in lights if k == "sph"] + [
            {"center": [-1.0, 0.8, -7.0], "radius": 0.8,
             "color": [0.8, 0.4, 0.3], "emission": [0, 0, 0],
             "reflectivity": 0.0},
            {"center": [1.5, 0.6, -6.0], "radius": 0.6,
             "color": [0.3, 0.6, 0.8], "emission": [0, 0, 0],
             "reflectivity": 0.0},
        ],
        "triangles": [l for k, l in lights if k == "tri"],
        "planes": [{"point": [0, 0, 0], "normal": [0, 1, 0],
                    "color": [0.6, 0.6, 0.6], "emission": [0, 0, 0],
                    "reflectivity": 0.0}],
        "light_sample": light_sample,
    }
    cfg.update(extra)
    return sm.scene_from_dict(cfg)


def _seed_means(scene, n_seeds, transport=None, accel="auto"):
    """Per-seed frame means of the red channel (one compile, seeds traced)."""
    tr = PathTracer(scene, transport=transport, accel=accel)
    f = jax.jit(tr.render_frame)
    out = []
    for s in range(n_seeds):
        cur, _v, _t, _r = f(POSE, np.uint32(101 + s), np.int32(0))
        out.append(float(np.asarray(cur.x).mean()))
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Schema / CLI / normalization
# ---------------------------------------------------------------------------

def test_schema_validation_and_normalization():
    s = _multi_scene(light_sample="power")
    assert s.light_sample == "power"
    with pytest.raises(ValueError, match="light_sample"):
        _multi_scene(light_sample="brightest")
    # with_overrides attaches the mode to any scene (the CLI path).
    s2 = load_scene("Cornell_Box").with_overrides(light_sample="uniform")
    assert s2.light_sample == "uniform"
    # Default is 'all': the tracer charges the reference's n_lights sweeps.
    tr_all = PathTracer(_multi_scene())
    assert not tr_all.one_light and tr_all.nee_sweeps == tr_all.n_lights == 3
    tr_one = PathTracer(_multi_scene(light_sample="power"))
    assert tr_one.one_light and tr_one.nee_sweeps == 1
    # <= 1 NEE light normalizes to 'all' (no selection draw, no mode).
    one = _multi_scene(powers=(5.0,), light_sample="power")
    tr1 = PathTracer(one)
    assert not tr1.one_light and tr1.light_mode == "all"
    # The procedural many-light scene loads and pre-sets the mode.
    lots = load_scene("lights:6")
    assert len(lots.lights) == 6 and lots.light_sample == "all"
    with pytest.raises(ValueError, match="lights:L"):
        load_scene("lights:abc")


def test_pick_probabilities():
    tr = PathTracer(_multi_scene(powers=(6.0, 1.5, 0.4),
                                 light_sample="power"))
    probs, cums, inv_total = tr._light_pick(tr.lights)
    # Equal radii: power ratios == emission ratios.
    np.testing.assert_allclose(probs, np.array([6.0, 1.5, 0.4]) / 7.9,
                               rtol=1e-6)
    assert cums[-1] == pytest.approx(1.0, abs=1e-6)
    area = 4.0 * np.pi * 0.25
    assert inv_total == pytest.approx(1.0 / (7.9 * area), rel=1e-6)
    tru = PathTracer(_multi_scene(light_sample="uniform"))
    probs_u, _c, _t = tru._light_pick(tru.lights)
    assert probs_u == [pytest.approx(1.0 / 3)] * 3


# ---------------------------------------------------------------------------
# Estimator correctness
# ---------------------------------------------------------------------------

def test_unbiased_mean_agreement():
    """E[one-light NEE] == E[full loop], both modes, mixed light kinds.

    48 seeds at 48x12x4spp: the measured standardized difference of the
    seed-mean distributions sits well inside 3 sigma (measured ~0.3-1.0;
    the bound is statistical — a trip here means a real estimator bias,
    which would be FAR outside it)."""
    base = _seed_means(_multi_scene(tri=True), 48)
    for mode in ("uniform", "power"):
        one = _seed_means(_multi_scene(tri=True, light_sample=mode), 48)
        se = np.hypot(base.std(ddof=1), one.std(ddof=1)) / np.sqrt(len(base))
        z = abs(one.mean() - base.mean()) / se
        assert z < 3.0, (mode, z, base.mean(), one.mean())


def test_power_beats_uniform_on_skewed_lights():
    """One dominant light (97% of total power): picking by power slashes
    the per-pixel direct-lighting variance vs uniform picking (which
    spends 2/3 of its NEE events on near-dark lights and pays 1/p = 3 on
    the bright one — estimate 3c w.p. 1/3, ~0 w.p. 2/3, variance ~2c^2;
    power picks the bright light ~97% of the time at weight ~1.03).

    depth=1 with the camera pitched down at the bare floor isolates the
    NEE estimate (no RR, no indirect paths, no emissive discs or sky in
    frame — every pixel is one direct-light event per sample), and the
    pin is per-pixel variance across seeds, summed, like test_sampler's.
    Measured ratio ~0.03-0.3 at these powers; 0.5 leaves headroom."""
    powers = (12.0, 0.2, 0.2)
    pose = Camera(position=(0.0, 2.0, -6.0), pitch=-1.2).pose()

    def seed_frames(mode, n_seeds=24):
        scene = _multi_scene(powers=powers, light_sample=mode, depth=1)
        f = jax.jit(PathTracer(scene).render_frame)
        return np.stack([
            np.asarray(f(pose, np.uint32(101 + s), np.int32(0))[0].x)
            for s in range(n_seeds)
        ])

    v_uni = seed_frames("uniform").var(axis=0, ddof=1).sum()
    v_pwr = seed_frames("power").var(axis=0, ddof=1).sum()
    assert v_pwr < 0.5 * v_uni, (v_pwr, v_uni)


def test_mis_one_light_agreement():
    """Under 'mis' both weight sites carry the pick probability (NEE's
    p_l and the BSDF-side emitter-hit p_nee): means must agree with
    mis + the full loop. Diffuse fixture — continuous scatter histories
    exercise the emitter-hit weight on every light hit."""
    base = _seed_means(_multi_scene(), 48, transport="mis")
    one = _seed_means(_multi_scene(light_sample="power"), 48,
                      transport="mis")
    se = np.hypot(base.std(ddof=1), one.std(ddof=1)) / np.sqrt(len(base))
    z = abs(one.mean() - base.mean()) / se
    assert z < 3.0, (z, base.mean(), one.mean())


def test_rays_and_occupancy_accounting():
    """Owed shadow rays per NEE event: 1 instead of n_lights. Pinned
    exactly at depth 1 (no RR divergence between modes): every sample is
    1 closest-hit + nee_sweeps shadow sweeps on the all-hit fixture."""
    # Camera inside the sphere field looking down at the floor: every
    # primary ray hits (floor covers the lower half; keep rays downward).
    scene = _multi_scene(depth=1, spp=4, camera={
        "fov_degrees": 40.0, "char_aspect_ratio": 1.0})
    pose = Camera(position=(0.0, 2.0, -6.0), pitch=-1.2).pose()
    _c, _v, _t, rays_all = jax.jit(PathTracer(scene).render_frame)(
        pose, np.uint32(3), np.int32(0))
    n_px = scene.width * scene.height
    assert float(rays_all) == n_px * 4 * (1 + 3)
    one = scene.with_overrides(light_sample="uniform")
    _c, _v, _t, rays_one, occ = jax.jit(
        PathTracer(one).render_frame, static_argnames=("with_occ",)
    )(pose, np.uint32(3), np.int32(0), with_occ=True)
    assert float(rays_one) == n_px * 4 * (1 + 1)
    # All-hit depth-1: every executed sweep was owed -> occupancy 1.
    assert float(occ) == pytest.approx(1.0, abs=1e-6)


# ---------------------------------------------------------------------------
# Backend / traversal / dynamic parity
# ---------------------------------------------------------------------------

def test_pallas_schedulers_match_oracle():
    scene = _multi_scene(tri=True, light_sample="power", w=128, h=8)
    cur_o, _vo, tot_o, rays_o = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(42), np.int32(0))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42), np.int32(0))
    err = "kernel"
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y),
                 (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=2e-5, err_msg=err)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o),
                                  err)
    assert float(rays_p) == float(rays_o), err


def test_traversals_and_dynamic_agree():
    """baked == array traversal (bitwise) and == dynamic at template
    values, in 'uniform' mode — whose pick thresholds are the same
    Python-float constants on every path (no traced emission values
    involved), so the bitwise pin is exact by construction."""
    scene = _multi_scene(light_sample="uniform")
    cb, _vb, tb, rb = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(7), np.int32(0))
    ca, _va, ta, ra = jax.jit(PathTracer(scene, accel="array").render_frame)(
        POSE, np.uint32(7), np.int32(0))
    assert float(ra) == float(rb)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_array_equal(np.asarray(ca.x), np.asarray(cb.x))
    dyn = PathTracer(scene, dynamic=True)
    cd, _vd, td, rd = jax.jit(dyn.render_frame_dynamic)(
        POSE, np.uint32(7), np.int32(0), pack_scene(scene))
    assert float(rd) == float(rb)
    np.testing.assert_array_equal(np.asarray(td), np.asarray(tb))
    np.testing.assert_array_equal(np.asarray(cd.x), np.asarray(cb.x))


def test_dynamic_power_mode_close():
    """'power' thresholds in dynamic mode are traced f32 scalars (the
    baked ones fold in f64 then round): a threshold can differ by an ulp,
    so the pin is allclose + exact structure, not bitwise (the flip
    probability per draw is ~2^-24 — see _one_light_nee)."""
    scene = _multi_scene(light_sample="power")
    cb, _vb, tb, rb = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(7), np.int32(0))
    dyn = PathTracer(scene, dynamic=True)
    cd, _vd, td, rd = jax.jit(dyn.render_frame_dynamic)(
        POSE, np.uint32(7), np.int32(0), pack_scene(scene))
    assert float(rd) == float(rb)
    np.testing.assert_array_equal(np.asarray(td), np.asarray(tb))
    np.testing.assert_allclose(np.asarray(cd.x), np.asarray(cb.x),
                               atol=2e-5)


def test_composes_with_fog_and_glass():
    """One-light NEE over the extension stack: fog scatter senders and
    glass surfaces take the same gated draws; schedulers stay
    decision-exact (rays + budgets)."""
    cfg_extra = {"fog": {"density": 0.08, "albedo": [0.9, 0.9, 0.9]}}
    scene = _multi_scene(light_sample="power", w=128, h=8, **cfg_extra)
    cur_o, _vo, tot_o, rays_o = jax.jit(PathTracer(scene).render_frame)(
        POSE, np.uint32(13), np.int32(0))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(13), np.int32(0))
    assert float(rays_p) == float(rays_o)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o))
    np.testing.assert_allclose(np.asarray(cur_p.x), np.asarray(cur_o.x),
                               atol=2e-5)
    assert np.isfinite(np.asarray(cur_o.x)).all()
