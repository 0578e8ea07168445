"""--mis light transport: balance-heuristic multiple importance sampling
between NEE area sampling and BSDF-hit emission (the capability extension
beyond the reference's no-MIS transport, shader.wgsl:455-458).

Invariants pinned here:
* same paths — MIS reweights, it never redraws (identical RNG chains, so
  identical ray counts / sample totals when no adaptive phase runs);
* same mean as --unbiased on front-lit scenes (both unbiased estimators);
* delta chains keep full emission weight (mirror view of a light);
* back-face light hits keep full weight (NEE's one-sided cos_l clamp,
  shader.wgsl:409, means NEE cannot reach them) — the furnace comes out at
  the true L/(1-rho), where --unbiased loses the interior re-emission;
* variance improves on a scene NEE handles poorly (huge nearby light);
* the Pallas kernels reproduce the oracle in mis mode.
"""

import jax
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models.scene import scene_from_dict
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def _render(scene, transport, seed=5, frame=0):
    step = make_render_step(scene, backend="jnp", transport=transport)
    return step(init_state(scene), POSE, np.uint32(seed), np.int32(frame))


def test_same_paths_all_transports():
    # spp=4 -> base == spp, no adaptive phase: all three transports owe
    # exactly the same traversals (with adaptivity, budgets legitimately
    # differ because the estimators have different sample variance).
    scene = load_scene("scene2").with_overrides(
        width=64, height=24, samples_per_pixel=4, max_depth=4
    )
    ref = _render(scene, "reference")
    unb = _render(scene, "unbiased")
    mis = _render(scene, "mis")
    assert float(ref.rays) == float(unb.rays) == float(mis.rays)
    np.testing.assert_array_equal(
        np.asarray(ref.state.samples), np.asarray(mis.state.samples)
    )
    # Net effect on scene2: removing the double count outweighs the NEE
    # the robust shadow segment recovers — the image darkens overall.
    a, m = np.asarray(ref.state.acc), np.asarray(mis.state.acc)
    assert m.mean() < a.mean()


def test_mirror_view_of_light_full_weight():
    """A light seen through a perfect mirror is a delta chain: NEE cannot
    sample it, so MIS must keep emission at weight 1 (same scene as the
    --unbiased mirror test)."""
    cfg = {
        "width": 32, "height": 32, "samples_per_pixel": 4, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [
            {"center": [0, 0, 10], "radius": 5.0, "color": [0, 0, 0],
             "emission": [3, 3, 3], "reflectivity": 0.0},
        ],
        "planes": [
            {"point": [0, 0, -4], "normal": [0, 0, 1], "color": [1, 1, 1],
             "emission": [0, 0, 0], "reflectivity": 1.0},
        ],
    }
    scene = scene_from_dict(cfg)
    mis = _render(scene, "mis")
    center = np.asarray(mis.state.acc)[:, 16, 16]
    np.testing.assert_allclose(center, 3.0, rtol=1e-4)


def test_furnace_mis_exact():
    """Inside an emissive sphere every interior hit is a BACK-face light hit
    — NEE's one-sided cos_l clamp gives those paths zero, so MIS must keep
    them at full weight: the true furnace value L/(1-rho). (--unbiased
    gates them off and reads L; reference reads L/(1-rho) by double-count
    coincidence, since NEE adds nothing here.)"""
    L, rho = 1.0, 0.5
    cfg = {
        "width": 16, "height": 16, "samples_per_pixel": 4, "max_depth": 16,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [{"center": [0, 0, 0], "radius": 5.0,
                     "color": [rho] * 3, "emission": [L] * 3,
                     "reflectivity": 0.0}],
        "planes": [],
    }
    scene = scene_from_dict(cfg)
    step = make_render_step(scene, backend="jnp", transport="mis", jit=True)
    state = init_state(scene)
    for f, seed in enumerate(range(16)):
        out = step(state, POSE, np.uint32(seed * 7919 + 3), np.int32(f))
        state = out.state
    acc = np.asarray(state.acc)
    expect = L / (1 - rho)
    assert abs(acc.mean() - expect) / expect < 0.05, (acc.mean(), expect)


def test_mis_equals_reference_in_cornell():
    """The shipped Cornell box's triangle lights have UP-facing normals
    (cross(e1,e2) of their winding), so the reference's one-sided cos_l
    clamp (shader.wgsl:405-406) zeroes NEE for every in-room receiver —
    the box is lit entirely by emission-on-hit. MIS must detect exactly
    that: back-face light hits keep weight 1 and the zero NEE term stays
    zero, reproducing the reference image (which is NOT double counted
    here, NEE adding nothing). --unbiased, which gates diffuse-hit
    emission assuming NEE covers it, under-lights this scene — MIS is the
    correct transport for it."""
    scene = load_scene("Cornell_Box").with_overrides(
        width=48, height=24, samples_per_pixel=4, max_depth=3
    )
    ref = _render(scene, "reference")
    mis = _render(scene, "mis")
    unb = _render(scene, "unbiased")
    a, m = np.asarray(ref.state.acc), np.asarray(mis.state.acc)
    # The only reachable front-face of these lights is their TOP (via the
    # 0.01 ceiling gap, y=0.99 vs 1.0) — there NEE genuinely works and the
    # reference genuinely double counts, so MIS applies small corrections
    # along ceiling-bounce paths; material differences stay confined to a
    # handful of pixels and the mean barely moves.
    frac_diff = (np.abs(m - a).max(axis=0) > 1e-2).mean()
    assert frac_diff < 0.03, frac_diff
    assert abs(m.mean() - a.mean()) / a.mean() < 0.02
    assert float(ref.rays) == float(mis.rays)
    # --unbiased now also matches (back-face light hits keep emission via
    # the lia gate; only the tiny genuinely-NEE-covered ceiling-gap paths
    # are de-duplicated):
    u = np.asarray(unb.state.acc)
    assert abs(u.mean() - a.mean()) / a.mean() < 0.02


def test_mis_mean_matches_unbiased_side_lit():
    """On a side-lit scene (light well off the floor's normal, so the
    reference's knife-edge shadow t_max — see direct_light — doesn't
    self-block NEE in either transport) MIS and --unbiased estimate the
    same integral; their many-seed means must agree."""
    cfg = {
        "width": 32, "height": 16, "samples_per_pixel": 4, "max_depth": 4,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [
            {"center": [12.0, 4.0, -6], "radius": 3.0, "color": [0, 0, 0],
             "emission": [4, 4, 4], "reflectivity": 0.0},
        ],
        "planes": [
            {"point": [0, -1, 0], "normal": [0, 1, 0],
             "color": [0.75, 0.75, 0.75], "emission": [0, 0, 0],
             "reflectivity": 0.0},
        ],
    }
    scene = scene_from_dict(cfg)
    means = {}
    for transport in ("unbiased", "mis"):
        step = make_render_step(scene, backend="jnp", transport=transport)
        state = init_state(scene)
        for f, seed in enumerate(range(64)):
            out = step(state, POSE, np.uint32(seed * 2654435761 % (2**32)),
                       np.int32(f))
            state = out.state
        means[transport] = float(np.asarray(state.acc).mean())
    rel = abs(means["mis"] - means["unbiased"]) / means["unbiased"]
    assert rel < 0.025, means


def test_mis_direct_matches_bsdf_truth_overhead():
    """The overhead-light case where the reference's NEE self-blocks (the
    shadow knife-edge): MIS's robust shadow segment must restore the full
    direct light. At depth 2 the BSDF-hit estimator (reference minus
    unbiased — emission added on diffuse hits) is a clean unbiased probe
    of the true direct illumination; MIS-direct (mis minus a no-emission
    baseline) must agree with it on the floor."""
    def mk(emission):
        return scene_from_dict({
            "width": 16, "height": 8, "samples_per_pixel": 4, "max_depth": 2,
            "frames_to_accumulate": 1,
            "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
            "spheres": [{"center": [0, 6.0, -6], "radius": 3.0,
                         "color": [0, 0, 0], "emission": [emission] * 3,
                         "reflectivity": 0.0}],
            "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                        "color": [0.75] * 3, "emission": [0, 0, 0],
                        "reflectivity": 0.0}],
        })

    def run(scene, transport, n=256):
        step = make_render_step(scene, backend="jnp", transport=transport)
        state = init_state(scene)
        for f in range(n):
            out = step(state, POSE,
                       np.uint32((f * 2654435761 + 11) % 2**32), np.int32(f))
            state = out.state
        return np.asarray(state.acc)

    s = mk(4.0)
    ref, unb, mis = (run(s, t) for t in ("reference", "unbiased", "mis"))
    base = run(mk(0.0), "reference")
    floor = np.s_[:, 4:, :]
    bsdf_direct = (ref - unb)[floor].mean()
    mis_direct = (mis - base)[floor].mean()
    assert abs(mis_direct - bsdf_direct) / bsdf_direct < 0.06, (
        mis_direct, bsdf_direct
    )
    # and the reference-quirk magnitude this guards against, pinned: NEE
    # self-blocking loses >half the direct light in reference mode.
    nee_direct = (unb - base)[floor].mean()
    assert nee_direct < 0.6 * bsdf_direct


def test_mis_variance_reduction_big_light():
    """A huge nearby light is the case NEE handles poorly (uniform area
    sampling wastes half its draws on the far hemisphere) and BSDF handles
    well; MIS should cut the per-pixel sample variance."""
    cfg = {
        "width": 32, "height": 16, "samples_per_pixel": 4, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [
            {"center": [0, 8.0, -6], "radius": 6.0, "color": [0, 0, 0],
             "emission": [4, 4, 4], "reflectivity": 0.0},
        ],
        "planes": [
            {"point": [0, -1, 0], "normal": [0, 1, 0],
             "color": [0.8, 0.8, 0.8], "emission": [0, 0, 0],
             "reflectivity": 0.0},
        ],
    }
    scene = scene_from_dict(cfg)
    var = {
        t: float(np.asarray(_render(scene, t).state.variance).mean())
        for t in ("unbiased", "mis")
    }
    assert var["mis"] < var["unbiased"], var


def _rough_floor_scene(rough, radius=3.0, emission=6.0):
    """A pure fuzzy-mirror floor under a sphere light sitting on the
    mirror axis of the camera's floor reflections (so the fuzz lobe,
    half-angle asin-ish sqrt(1-c) ~ 30 deg at roughness 0.5, genuinely
    covers the light)."""
    return scene_from_dict({
        "width": 32, "height": 16, "samples_per_pixel": 4, "max_depth": 2,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [{"center": [0, 4.0, -12], "radius": radius,
                     "color": [0, 0, 0], "emission": [emission] * 3,
                     "reflectivity": 0.0}],
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [0.9, 0.9, 0.9], "emission": [0, 0, 0],
                    "reflectivity": 1.0, "roughness": rough}],
    })


def test_mis_rough_metal_mean_unbiased():
    """The fuzzy-metal lobe under 'mis' is weighted EXACTLY (the analytic
    fuzz pdf, sampling.fuzz_pdf): on a pure fuzzy mirror floor the mis
    mean must equal the metal transport alone. Ground truth by linear
    decomposition: unbiased = metal + Lambert-NEE ghost, and at depth 2
    the ghost is roughness-independent (NEE precedes the scatter, at
    identical hit points with identical light draws) — so

        E[mis(f)] = E[unb(f)] - E[unb(0)] + E[mis(0)],

    where the roughness-0 renders are exact delta treatments (mis(0) has
    zero NEE at reflectivity 1 and weight-1 mirror emission). A delta
    treatment of the fuzz lobe would instead reproduce unb(f) minus the
    ghost plus NOTHING from NEE — the decomposition catches both a lost
    and a double-counted metal lobe."""
    def run(scene, transport, n=64):
        step = make_render_step(scene, backend="jnp", transport=transport)
        state = init_state(scene)
        for f in range(n):
            out = step(state, POSE,
                       np.uint32((f * 2654435761 + 3) % 2**32), np.int32(f))
            state = out.state
        return np.asarray(state.acc)

    sf, s0 = _rough_floor_scene(0.5), _rough_floor_scene(0.0)
    floor = np.s_[:, 8:, :]
    a = run(sf, "unbiased")[floor].mean()
    b = run(sf, "mis")[floor].mean()
    c = run(s0, "unbiased")[floor].mean()
    d = run(s0, "mis")[floor].mean()
    truth = a - c + d
    # Measured at this seed schedule: rel ~ 0.005 with the ghost (a - c
    # + d differs from a by ~23%) far above the tolerance — the test has
    # real power against a mis-weighted lobe.
    assert abs(b - truth) / truth < 0.03, (b, truth, a, c, d)
    assert (c - d) / truth > 0.1  # the ghost the decomposition removes


def test_mis_rough_metal_variance_reduction():
    """A SMALL bright light seen via a wide fuzz lobe is the case BSDF
    sampling handles poorly; with the metal lobe in the NEE balance
    (rather than delta-treated), mis must cut the sample variance."""
    scene = _rough_floor_scene(0.5, radius=0.6, emission=150.0)
    var = {
        t: float(np.asarray(_render(scene, t).state.variance).mean())
        for t in ("unbiased", "mis")
    }
    # measured: ~153 (unbiased) vs ~75 (mis)
    assert var["mis"] < 0.75 * var["unbiased"], var


def test_mis_rough_pallas_matches_oracle():
    """The rough-metal mis path through the GPU kernel —
    exact decisions, radiance to interpret-mode tolerance."""
    scene = _rough_floor_scene(0.5).with_overrides(
        width=64, height=8, samples_per_pixel=8, max_depth=3
    )
    of = jax.jit(PathTracer(scene, transport="mis").render_frame)
    cur_o, var_o, tot_o, rays_o = of(POSE, np.uint32(11), np.int32(0))
    pf = jax.jit(
        pallas_kernel.make_render_frame(scene, interpret=True, transport="mis")
    )
    cur_p, var_p, tot_p, rays_p, _occ = pf(POSE, np.uint32(11), np.int32(0))
    err = "kernel"
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y),
                 (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5, err_msg=err
        )
    np.testing.assert_array_equal(
        np.asarray(tot_p), np.asarray(tot_o), err
    )
    assert float(rays_p) == float(rays_o), err


def test_mis_pallas_matches_oracle():
    """The GPU kernel reproduces the mis-mode oracle (interpret
    mode — same backend math, bit-equal decisions)."""
    scene = load_scene("Cornell_Box").with_overrides(
        width=140, height=10, samples_per_pixel=8, max_depth=3
    )
    of = jax.jit(PathTracer(scene, transport="mis").render_frame)
    cur_o, var_o, tot_o, rays_o = of(POSE, np.uint32(11), np.int32(0))
    pf = jax.jit(
        pallas_kernel.make_render_frame(scene, interpret=True, transport="mis")
    )
    cur_p, var_p, tot_p, rays_p, _occ = pf(POSE, np.uint32(11), np.int32(0))
    err = "kernel"
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y),
                 (cur_p.z, cur_o.z)):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=2e-5, err_msg=err
        )
    np.testing.assert_array_equal(
        np.asarray(tot_p), np.asarray(tot_o), err
    )
    assert float(rays_p) == float(rays_o), err
