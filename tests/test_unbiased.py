"""--unbiased light transport: removes the reference's emission+NEE double
counting. Same RNG chains/paths; emission gated to camera hits and
post-mirror hits only."""

import jax
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models.scene import scene_from_dict
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def _render(scene, unbiased, seed=5):
    step = make_render_step(scene, backend="jnp", unbiased=unbiased)
    return step(init_state(scene), POSE, np.uint32(seed), np.int32(0))


def test_same_paths_darker_image():
    scene = load_scene("scene2").with_overrides(
        width=64, height=24, samples_per_pixel=4, max_depth=4
    )
    ref = _render(scene, unbiased=False)
    unb = _render(scene, unbiased=True)
    a, b = np.asarray(ref.state.acc), np.asarray(unb.state.acc)
    # identical paths -> identical ray counts and sample totals
    assert float(ref.rays) == float(unb.rays)
    np.testing.assert_array_equal(
        np.asarray(ref.state.samples), np.asarray(unb.state.samples)
    )
    # removing double-counted emission can only darken
    assert (b <= a + 1e-6).all()
    assert b.mean() < a.mean()


def test_depth1_identical():
    # At depth 1 the camera hit's emission is legitimate in both modes.
    scene = load_scene("scene2").with_overrides(
        width=64, height=24, samples_per_pixel=4, max_depth=1
    )
    ref = _render(scene, unbiased=False)
    unb = _render(scene, unbiased=True)
    np.testing.assert_array_equal(
        np.asarray(ref.state.acc), np.asarray(unb.state.acc)
    )


def test_mirror_view_of_light_kept():
    """A light seen through a perfect mirror must still emit in unbiased
    mode (NEE cannot sample that path)."""
    cfg = {
        "width": 32, "height": 32, "samples_per_pixel": 4, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        # mirror straight ahead, light behind the camera
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
    unb = _render(scene, unbiased=True)
    center = np.asarray(unb.state.acc)[:, 16, 16]
    # camera ray -> mirror -> light: emission 3 through a perfect mirror
    np.testing.assert_allclose(center, 3.0, rtol=1e-4)


def test_furnace_unbiased_matches_physics():
    """Inside an emissive sphere, every hit is a BACK face — NEE can never
    sample it (its one-sided cos_l is <= 0 for chords), so unbiased mode
    keeps emission at every bounce (the hit.light_inv_area == 0 gate) and
    the estimator targets the true furnace value L/(1-rho). (An earlier
    implementation gated emission off after any diffuse scatter, silently
    under-counting NEE-unreachable emitters to exactly L.)"""
    L, rho = 1.0, 0.5
    cfg = {
        # spp 4 = base: the clean normalization path (spp > 4 would
        # trigger the reference's base/spp darkening quirk on these
        # near-zero-variance pixels and obscure the physics).
        "width": 16, "height": 16, "samples_per_pixel": 4, "max_depth": 24,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [{"center": [0, 0, 0], "radius": 5.0,
                     "color": [rho] * 3, "emission": [L] * 3,
                     "reflectivity": 0.0}],
        "planes": [],
    }
    scene = scene_from_dict(cfg)
    unb = _render(scene, unbiased=True)
    acc = np.asarray(unb.state.acc)
    # Russian roulette + the depth cap leave Monte-Carlo noise around the
    # closed form L/(1-rho) = 2; the image mean over 16x16x4 samples
    # must land within a few percent.
    assert abs(acc.mean() - L / (1 - rho)) < 0.12, acc.mean()


def test_plane_light_visible_after_diffuse_bounce():
    """Plane lights are never NEE-sampled (shader.wgsl:390-391), so a
    diffusely-bounced path hitting an emissive plane is NEE-unreachable —
    unbiased mode must keep its emission (the indirect glow of a glowing
    ceiling on a matte floor)."""
    cfg = {
        "width": 32, "height": 16, "samples_per_pixel": 16, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "planes": [
            # matte floor the camera looks at
            {"point": [0, -1, 0], "normal": [0, 1, 0],
             "color": [0.8, 0.8, 0.8], "emission": [0, 0, 0],
             "reflectivity": 0.0},
            # glowing ceiling: only reachable via the floor bounce
            {"point": [0, 4, 0], "normal": [0, -1, 0], "color": [0, 0, 0],
             "emission": [4, 4, 4], "reflectivity": 0.0},
        ],
    }
    scene = scene_from_dict(cfg)
    unb = _render(scene, unbiased=True)
    ref = _render(scene, unbiased=False)
    floor_u = np.asarray(unb.state.acc)[0, 12:, :].mean()
    floor_r = np.asarray(ref.state.acc)[0, 12:, :].mean()
    assert floor_u > 0.1, floor_u  # the glow is there...
    # ...and equals the reference transport here: with no NEE-sampled
    # lights in the scene there is nothing to double count.
    np.testing.assert_allclose(floor_u, floor_r, rtol=1e-5)
