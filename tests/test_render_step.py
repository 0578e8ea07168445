"""Render-step contract: temporal accumulation semantics
(shader.wgsl:612-620), accumulation reset on frame 0, adaptive-sampling
bookkeeping, determinism, and tonemap wiring."""

import jax
import jax.numpy as jnp
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.ops.tracer import PathTracer, base_sample_count, cam_from_pose
from terminal_raytracer.runtime import init_state, make_render_step


def _tiny_scene(**kw):
    defaults = dict(width=32, height=16, samples_per_pixel=4, max_depth=2)
    defaults.update(kw)
    return load_scene("scene2").with_overrides(**defaults)


def test_accumulation_running_mean():
    scene = _tiny_scene()
    step = make_render_step(scene, full_color=True, backend="jnp")
    cam = Camera()
    state = init_state(scene)

    frames = []
    solo_step = make_render_step(scene, backend="jnp", jit=False)
    for f in range(3):
        # Render each frame independently with the same (seed, frame_number)
        # the stateful path will use — frame_number feeds the RNG
        # (shader.wgsl:507). From zero-initialized accumulation,
        # acc = current * alpha with alpha = 1/(f+1), so current = acc*(f+1).
        solo = solo_step(
            init_state(scene), cam.pose(), np.uint32(100 + f), np.int32(f)
        )
        frames.append(np.asarray(solo.state.acc) * (f + 1))

    # Now accumulate the same seeds through the stateful path.
    out = step(state, cam.pose(), np.uint32(100), np.int32(0))
    out = step(out.state, cam.pose(), np.uint32(101), np.int32(1))
    out = step(out.state, cam.pose(), np.uint32(102), np.int32(2))
    expected = (frames[0] + frames[1] + frames[2]) / 3.0
    np.testing.assert_allclose(np.asarray(out.state.acc), expected, rtol=1e-4, atol=1e-6)


def test_frame_zero_resets_accumulation():
    scene = _tiny_scene()
    step = make_render_step(scene, backend="jnp")
    cam = Camera()
    out = step(init_state(scene), cam.pose(), np.uint32(5), np.int32(0))
    out = step(out.state, cam.pose(), np.uint32(6), np.int32(1))
    # Camera "moved": frame_number goes back to 0 -> acc must equal a fresh
    # frame render, ignoring history.
    moved = step(out.state, cam.pose(), np.uint32(7), np.int32(0))
    fresh = make_render_step(scene, backend="jnp")(
        init_state(scene), cam.pose(), np.uint32(7), np.int32(0)
    )
    np.testing.assert_allclose(
        np.asarray(moved.state.acc), np.asarray(fresh.state.acc), rtol=1e-6
    )


def test_output_shapes_and_dtypes():
    scene = _tiny_scene()
    cam = Camera()
    out = make_render_step(scene, full_color=True, backend="jnp")(
        init_state(scene), cam.pose(), np.uint32(1), np.int32(0)
    )
    assert out.rgb.shape == (16, 32, 3) and out.rgb.dtype == jnp.uint8
    assert out.glyphs.shape == (16, 32) and out.glyphs.dtype == jnp.uint8
    assert out.state.acc.shape == (3, 16, 32)
    assert out.state.variance.shape == (16, 32)
    assert float(out.rays) > 0

    out_a = make_render_step(scene, full_color=False, backend="jnp")(
        init_state(scene), cam.pose(), np.uint32(1), np.int32(0)
    )
    assert int(np.asarray(out_a.glyphs).max()) > 0  # ASCII mode fills glyphs


def test_oracle_occupancy_measured():
    """The jnp oracle surfaces measured sweep-weighted occupancy (owed
    sweeps over executed lane-iteration sweeps — the GPU kernel's
    accounting). Exact pin: a depth-1 all-hit scene keeps every lane
    owing every sweep of its single iteration -> occupancy exactly 1.
    A deep multi-bounce scene must land strictly inside (0, 1)."""
    pose = Camera().pose()
    s1 = load_scene("Cornell_Box").with_overrides(
        width=32, height=16, samples_per_pixel=4, max_depth=1
    )
    out = make_render_step(s1, backend="jnp")(
        init_state(s1), pose, np.uint32(5), np.int32(0)
    )
    assert float(out.occupancy) == 1.0

    s2 = load_scene("scene2").with_overrides(
        width=64, height=24, samples_per_pixel=16, max_depth=8
    )
    out2 = make_render_step(s2, backend="jnp")(
        init_state(s2), pose, np.uint32(5), np.int32(0)
    )
    occ = float(out2.occupancy)
    assert 0.0 < occ < 1.0, occ
    # Consistency with the owed-ray count: occ * capacity == rays.
    # (scene2 has one light: 2 sweeps per executed lane-iteration.)
    lanes = 64 * 24
    cap = float(out2.rays) / occ
    m = lanes * 2
    r = cap % m
    assert min(r, m - r) < 1e-3 * cap  # whole iterations of the grid


def test_determinism_fixed_seed():
    scene = _tiny_scene()
    cam = Camera()
    step = make_render_step(scene, backend="jnp")
    a = step(init_state(scene), cam.pose(), np.uint32(42), np.int32(0))
    b = step(init_state(scene), cam.pose(), np.uint32(42), np.int32(0))
    np.testing.assert_array_equal(np.asarray(a.rgb), np.asarray(b.rgb))
    np.testing.assert_array_equal(np.asarray(a.state.acc), np.asarray(b.state.acc))


def test_no_nans_or_infs():
    scene = _tiny_scene(samples_per_pixel=8, max_depth=8)
    cam = Camera()
    out = make_render_step(scene, backend="jnp")(
        init_state(scene), cam.pose(), np.uint32(3), np.int32(0)
    )
    acc = np.asarray(out.state.acc)
    assert np.isfinite(acc).all()
    assert (acc >= 0).all()


def test_adaptive_sample_counts():
    # spp large enough that base < spp: sample counts are in [base, spp].
    scene = load_scene("Cornell_Box").with_overrides(
        width=32, height=16, samples_per_pixel=16, max_depth=3
    )
    cam = Camera()
    out = make_render_step(scene, backend="jnp")(
        init_state(scene), cam.pose(), np.uint32(11), np.int32(0)
    )
    samples = np.asarray(out.state.samples)
    base = base_sample_count(16)
    assert base == 4
    assert samples.min() >= base
    assert samples.max() <= 16
    var = np.asarray(out.state.variance)
    # Pixels that got extra samples must be exactly the high-variance ones.
    assert ((samples > base) == (var > 10.0)).all() or (samples > base).sum() == 0


def test_base_sample_count_quirk():
    # spp=1 -> base=4 > spp: the reference's 4x brightening case must run
    # (no adaptive loop) and produce a finite image.
    assert base_sample_count(1) == 4
    scene = _tiny_scene(samples_per_pixel=1)
    cam = Camera()
    out = make_render_step(scene, backend="jnp")(
        init_state(scene), cam.pose(), np.uint32(1), np.int32(0)
    )
    assert np.isfinite(np.asarray(out.state.acc)).all()
    assert np.asarray(out.state.samples).max() == 4


def test_camera_move_no_retrace():
    # Moving the camera only changes the pose array: jit must not retrace.
    scene = _tiny_scene()
    step = make_render_step(scene, backend="jnp")
    cam = Camera()
    state = init_state(scene)
    out = step(state, cam.pose(), np.uint32(0), np.int32(0))
    compiled_before = step._cache_size()
    for key in "wasd":
        cam.apply_key(key)
        out = step(out.state, cam.pose(), np.uint32(1), np.int32(0))
    assert step._cache_size() == compiled_before == 1


def test_until_noise_convergence_stop():
    """--until-noise: headless rendering stops as soon as the accumulated
    noise estimate (mean sample variance / total samples) drops under the
    threshold, frame cap otherwise."""
    from terminal_raytracer.models import load_scene
    from terminal_raytracer.runtime.engine import Engine

    scene = load_scene("scene2").with_overrides(
        width=32, height=8, samples_per_pixel=4, max_depth=2
    )
    eng = Engine(scene, backend="jnp", deterministic=3, pipeline=False)
    eng.run_headless(10, until_noise=1e9)  # any noise passes immediately
    assert eng.frame_count == 1
    eng2 = Engine(scene, backend="jnp", deterministic=3, pipeline=False)
    eng2.run_headless(6, until_noise=0.0)  # unreachable -> cap
    assert eng2.frame_count == 6


def test_fuse_nee_bit_identical():
    """The fuse_nee probe path (deferred fused two-light shadow sweep,
    geometry.occluded2) renders BIT-identically to the shipped per-light
    occluded() calls — oracle and the GPU kernel alike (it
    only reorders op scheduling, not values)."""
    from terminal_raytracer.ops import pallas_kernel
    from terminal_raytracer.ops import tracer as tracer_mod

    scene = load_scene("Cornell_Box").with_overrides(
        width=64, height=32, samples_per_pixel=8, max_depth=6)
    pose = Camera().pose()
    args = (pose, np.uint32(42), np.int32(0))

    a = jax.jit(PathTracer(scene, fuse_nee=False).render_frame)(*args)
    b = jax.jit(PathTracer(scene, fuse_nee=True).render_frame)(*args)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    try:
        tracer_mod.FUSE_NEE = False
        p0 = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))(*args)
        tracer_mod.FUSE_NEE = True
        p1 = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))(*args)
    finally:
        tracer_mod.FUSE_NEE = False
    for x, y in zip(jax.tree_util.tree_leaves(p0), jax.tree_util.tree_leaves(p1)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
