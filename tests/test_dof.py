"""Thin-lens depth of field (--aperture/--focus — extension; the reference
camera is pinhole, shader.wgsl:519-546). Statically gated in gen_ray, so
aperture = 0 draws nothing extra and stays bit-exact with the reference
chains; aperture > 0 focuses the plane at focus_distance and blurs
elsewhere, in every scheduler."""

import jax
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models.scene import scene_from_dict
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def _two_spheres(aperture, focus):
    """An emissive sphere at z=-4 (the focal plane) and one at z=-12:
    direct visibility at depth 1 makes the circle-of-confusion measurable
    without lighting noise."""
    return scene_from_dict({
        # spp=4 keeps base == spp: the clean sum/4 normalization (any
        # larger spp scales values by base/spp, the reference quirk)
        "width": 64, "height": 32, "samples_per_pixel": 4, "max_depth": 1,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0,
                   "aperture": aperture, "focus_distance": focus},
        "spheres": [
            {"center": [-0.8, 0.0, -4.0], "radius": 0.7,
             "color": [0, 0, 0], "emission": [3.0, 0.2, 0.2],
             "reflectivity": 0.0},
            {"center": [2.4, 0.0, -12.0], "radius": 2.1,
             "color": [0, 0, 0], "emission": [0.2, 0.2, 3.0],
             "reflectivity": 0.0},
        ],
        "planes": [],
    })


def _render(scene, seed=3):
    step = make_render_step(scene, backend="jnp")
    return np.asarray(
        step(init_state(scene), POSE, np.uint32(seed), np.int32(0)).state.acc
    )


def test_aperture_zero_bit_exact():
    base = load_scene("scene2").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=3
    )
    explicit = base.with_overrides(aperture=0.0, focus_distance=5.0)
    np.testing.assert_array_equal(_render(base), _render(explicit))


def test_focal_plane_sharp_background_blurred():
    pin = _render(_two_spheres(0.0, 4.0))
    dof = _render(_two_spheres(1.0, 4.0))
    diff = np.abs(dof - pin).max(axis=0)  # [H, W]
    h, w = diff.shape

    def region_mean(img, x_frac_lo, x_frac_hi):
        return img[:, int(w * x_frac_lo):int(w * x_frac_hi)].mean()

    # In-focus sphere occupies the left third; out-of-focus sphere the
    # right half. The lens must blur the far sphere's region much more
    # than the focal sphere's.
    focal_diff = region_mean(diff, 0.05, 0.35)
    far_diff = region_mean(diff, 0.55, 0.95)
    assert far_diff > 3.0 * focal_diff, (focal_diff, far_diff)
    # and the image genuinely changed
    assert far_diff > 1e-3


def test_dof_edge_spread():
    """Blur widens the out-of-focus silhouette: more pixels carry partial
    blue than in the pinhole render."""
    pin = _render(_two_spheres(0.0, 4.0))
    dof = _render(_two_spheres(1.0, 4.0))

    def partial_blue(img):
        # strictly between the sky's blue (<= 0.8) and the emitter's 3.0:
        # pixels whose samples straddle the silhouette
        b = img[2]
        return ((b > 1.0) & (b < 2.9)).sum()

    assert partial_blue(dof) > 1.5 * partial_blue(pin), (
        partial_blue(dof), partial_blue(pin)
    )


def test_dof_pallas_matches_oracle():
    scene = _two_spheres(0.35, 4.0)
    of = jax.jit(PathTracer(scene).render_frame)
    cur_o, _v, tot_o, rays_o = of(POSE, np.uint32(9), np.int32(0))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(9), np.int32(0))
    assert float(rays_p) == float(rays_o)
    np.testing.assert_array_equal(
        np.asarray(tot_p), np.asarray(tot_o)
    )
    np.testing.assert_allclose(
        np.asarray(cur_p.x), np.asarray(cur_o.x), atol=2e-5,
        err_msg="kernel",
    )
