"""Per-pixel parity of the wavefront tracer against the scalar NumPy
reference (tests/scalar_ref.py), which faithfully executes the reference
kernel's divergent control flow per pixel.

Because the vectorized tracer gates every RNG state advance by the exact
control-flow condition a scalar thread would evaluate (ops/rng.py), both
implementations consume *identical* RNG chains — so same-seed renders agree
to float rounding, not just in distribution. This is stronger than the
"parity modulo RNG" requirement (PARITY.md).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scalar_ref import render_pixel

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.ops.tracer import PathTracer, cam_from_pose

CAM = cam_from_pose(Camera().pose())


def _vec_pixels(scene, pixels, seed, frame, cam=CAM):
    tracer = PathTracer(scene)
    xs = jnp.asarray(np.array([[x for x, _ in pixels]], np.int32))
    ys = jnp.asarray(np.array([[y for _, y in pixels]], np.int32))
    cur, var, total, rays = jax.jit(
        lambda s, f: tracer.render_lanes(cam, xs, ys, s, f)
    )(np.uint32(seed), np.int32(frame))
    return (
        np.stack([np.asarray(cur.x)[0], np.asarray(cur.y)[0], np.asarray(cur.z)[0]], -1),
        np.asarray(var)[0],
        np.asarray(total)[0],
    )


PIXELS = [(50, 40), (20, 10), (80, 25), (50, 25), (10, 45)]


@pytest.mark.parametrize("scene_name", ["Cornell_Box", "scene2"])
@pytest.mark.parametrize("depth", [1, 3, 6])
def test_same_seed_sample_mean_parity(scene_name, depth):
    # spp=4 => base == spp: adaptive loop statically off, current = sum/4.
    scene = load_scene(scene_name).with_overrides(
        width=100, height=50, samples_per_pixel=4, max_depth=depth
    )
    vec, _, _ = _vec_pixels(scene, PIXELS, seed=1234, frame=0)
    for i, (px, py) in enumerate(PIXELS):
        ref = render_pixel(scene, px, py, seed=1234, frame_number=0, n_samples=4)
        np.testing.assert_allclose(
            vec[i], ref, rtol=2e-4, atol=2e-6,
            err_msg=f"pixel ({px},{py}) depth={depth} scene={scene_name}",
        )


def test_deep_bounce_russian_roulette_parity():
    # depth 32 exercises Russian roulette (active from bounce 4) and the
    # kill-before-compensate ordering.
    scene = load_scene("demo").with_overrides(
        width=64, height=32, samples_per_pixel=4, max_depth=32
    )
    pixels = [(10, 10), (32, 16), (50, 28)]
    vec, _, _ = _vec_pixels(scene, pixels, seed=77, frame=2)
    for i, (px, py) in enumerate(pixels):
        ref = render_pixel(scene, px, py, seed=77, frame_number=2, n_samples=4)
        np.testing.assert_allclose(
            vec[i], ref, rtol=5e-4, atol=5e-6, err_msg=f"pixel ({px},{py})"
        )


def test_seed_and_frame_decorrelate():
    scene = load_scene("Cornell_Box").with_overrides(
        width=100, height=50, samples_per_pixel=4, max_depth=3
    )
    a, _, _ = _vec_pixels(scene, PIXELS, seed=1, frame=0)
    b, _, _ = _vec_pixels(scene, PIXELS, seed=2, frame=0)
    c, _, _ = _vec_pixels(scene, PIXELS, seed=1, frame=1)
    assert not np.allclose(a, b)
    assert not np.allclose(a, c)
    a2, _, _ = _vec_pixels(scene, PIXELS, seed=1, frame=0)
    np.testing.assert_array_equal(a, a2)  # deterministic given (seed, frame)


@pytest.mark.parametrize("keys", [
    ("w", "w", "left"),
    ("a", "up", "up", "d"),
    ("s", "right", "down", "w", "left", "left"),
])
def test_same_seed_parity_at_moved_poses(keys):
    """Parity after WASD/arrow movement: the interactive camera's
    yaw/pitch basis (reference camera.rs:17-26, key steps lib.rs:393-405)
    feeds both tracers; same-seed renders still agree to float rounding at
    non-default poses."""
    scene = load_scene("Cornell_Box").with_overrides(
        width=100, height=50, samples_per_pixel=4, max_depth=3
    )
    cam = Camera()
    for k in keys:
        assert cam.apply_key(k)
    vec, _, _ = _vec_pixels(
        scene, PIXELS, seed=321, frame=1, cam=cam_from_pose(cam.pose())
    )
    for i, (px, py) in enumerate(PIXELS):
        ref = render_pixel(
            scene, px, py, seed=321, frame_number=1, n_samples=4,
            position=cam.position, yaw=cam.yaw, pitch=cam.pitch,
        )
        np.testing.assert_allclose(
            vec[i], ref, rtol=2e-4, atol=2e-6,
            err_msg=f"pixel ({px},{py}) after keys={keys}",
        )
