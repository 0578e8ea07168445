"""Offline lax.scan accumulation (runtime/offline.py) vs the Python-driven
frame loop: identical accumulation semantics in one compiled program."""

import jax
import jax.numpy as jnp
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.runtime import init_state, make_render_step
from terminal_raytracer.runtime.offline import make_scan_renderer


def test_scan_matches_python_loop():
    scene = load_scene("scene2").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=3
    )
    pose = Camera().pose()
    seeds = np.array([11, 22, 33, 44, 55], np.uint32)

    render = make_scan_renderer(scene, n_frames=5, full_color=True, backend="jnp")
    from terminal_raytracer.runtime.state import init_state as mk

    state_s, rgb_s, _, rays_s = render(mk(scene), pose, jnp.asarray(seeds))

    step = make_render_step(scene, full_color=True, backend="jnp")
    state = init_state(scene)
    total_rays = 0.0
    for f, seed in enumerate(seeds):
        out = step(state, pose, np.uint32(seed), np.int32(f))
        state = out.state
        total_rays += float(out.rays)

    np.testing.assert_allclose(
        np.asarray(state_s.acc), np.asarray(state.acc), atol=1e-5
    )
    np.testing.assert_array_equal(np.asarray(rgb_s), np.asarray(out.rgb))
    assert float(rays_s) == total_rays


def test_chunked_headless_matches_per_frame():
    """Engine.run_headless with the chunked dispatch (k frames per compiled
    call) is bit-identical to per-frame driving on the same deterministic
    seed sequence — including a non-divisible n_frames (8+8+3)."""
    from terminal_raytracer.runtime.engine import Engine

    scene = load_scene("scene2").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=3
    )
    fetched = {}
    for chunk in ("auto", 1):
        eng = Engine(scene, full_color=False, backend="jnp",
                     deterministic=7)
        fetched[chunk] = eng.run_headless(19, chunk=chunk)
        assert eng.frame_count == 19
        fetched[f"state{chunk}"] = np.asarray(eng.state.acc)
    rgb_c, gly_c, rays_c, spp_c, _ = fetched["auto"]
    rgb_p, gly_p, rays_p, spp_p, _ = fetched[1]
    np.testing.assert_array_equal(np.asarray(rgb_c), np.asarray(rgb_p))
    np.testing.assert_array_equal(np.asarray(gly_c), np.asarray(gly_p))
    assert float(rays_c) == float(rays_p)  # last frame's count either way
    assert float(spp_c) == float(spp_p)
    np.testing.assert_array_equal(fetched["stateauto"], fetched["state1"])


def test_render_accumulated_convenience():
    from terminal_raytracer.runtime.offline import render_accumulated

    scene = load_scene("scene2").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=2
    )
    _, rgb, glyphs, rays = render_accumulated(
        scene, Camera().pose(), n_frames=3, seed=0, full_color=False,
        backend="jnp",
    )
    assert rgb.shape == (16, 48, 3) and rgb.dtype == np.uint8
    assert glyphs.max() > 0
    assert rays > 0
    # deterministic given the seed
    _, rgb2, _, _ = render_accumulated(
        scene, Camera().pose(), n_frames=3, seed=0, full_color=False,
        backend="jnp",
    )
    np.testing.assert_array_equal(rgb, rgb2)


def test_orbit_scan_renderer():
    """The whole turntable orbit as one XLA program: scan over poses,
    fori over accumulation frames, per-pose accumulation reset."""
    import numpy as np

    from terminal_raytracer.models import Camera, load_scene
    from terminal_raytracer.runtime.offline import (
        make_orbit_scan_renderer,
    )

    scene = load_scene("scene2").with_overrides(
        width=32, height=12, samples_per_pixel=4, max_depth=2
    )
    n_poses, m = 3, 2
    render = make_orbit_scan_renderer(scene, n_poses, m, backend="jnp")
    poses = np.stack([
        Camera.look_at([np.sin(a) * 3, 0.5, -5 + np.cos(a) * 3],
                       [0, 0, -5]).pose()
        for a in (0.0, 2.1, 4.2)
    ])
    rng = np.random.RandomState(0)
    seeds = rng.randint(0, 2**32, size=(n_poses, m),
                        dtype=np.uint64).astype(np.uint32)
    rgbs, glyphs, rays = render(poses, seeds)
    rgbs = np.asarray(rgbs)
    assert rgbs.shape == (n_poses, 12, 32, 3)
    assert float(rays) > 0
    assert not np.array_equal(rgbs[0], rgbs[1])
    assert not np.array_equal(rgbs[1], rgbs[2])
    # per-pose reset: pose 0 rendered alone must equal pose 0 of the orbit
    solo, _g, _r = render(
        np.repeat(poses[:1], n_poses, 0),
        np.stack([seeds[0]] * n_poses),
    )
    np.testing.assert_array_equal(np.asarray(solo)[2], np.asarray(solo)[0])


def test_noise_scan_stops_and_caps():
    """--until-noise composed with --scan: a huge threshold
    stops after the first chunk; threshold 0 runs to the frame cap and is
    bit-identical to the plain scan on the same seeds."""
    from terminal_raytracer.runtime.offline import (
        make_noise_scan_renderer,
    )

    scene = load_scene("scene2").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=3
    )
    pose = Camera().pose()
    seeds = (np.arange(8, dtype=np.uint64) * 977 + 13).astype(np.uint32)

    render_hi = make_noise_scan_renderer(
        scene, 8, threshold=1e9, chunk=2, full_color=True, backend="jnp"
    )
    _st, _rgb, _gly, _rays, done = jax.device_get(
        render_hi(init_state(scene), pose, jnp.asarray(seeds))
    )
    assert int(done) == 2  # first chunk always renders, then converged

    render_lo = make_noise_scan_renderer(
        scene, 8, threshold=0.0, chunk=2, full_color=True, backend="jnp"
    )
    st_n, rgb_n, _g, rays_n, done_n = render_lo(
        init_state(scene), pose, jnp.asarray(seeds)
    )
    assert int(jax.device_get(done_n)) == 8  # cap respected

    render = make_scan_renderer(scene, n_frames=8, full_color=True,
                                backend="jnp")
    st_s, rgb_s, _g2, rays_s = render(init_state(scene), pose,
                                      jnp.asarray(seeds))
    np.testing.assert_array_equal(np.asarray(st_n.acc), np.asarray(st_s.acc))
    np.testing.assert_array_equal(np.asarray(rgb_n), np.asarray(rgb_s))
    assert float(jax.device_get(rays_n)) == float(jax.device_get(rays_s))


def test_noise_scan_chunk_clamps_to_divisor():
    """A chunk that doesn't divide the cap clamps down (8->...->1) so the
    cap stays exact."""
    from terminal_raytracer.runtime.offline import (
        make_noise_scan_renderer,
    )

    scene = load_scene("scene2").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=2
    )
    pose = Camera().pose()
    seeds = (np.arange(7, dtype=np.uint64) * 31 + 5).astype(np.uint32)
    render = make_noise_scan_renderer(
        scene, 7, threshold=0.0, chunk=8, full_color=True, backend="jnp"
    )
    _st, _rgb, _gly, _rays, done = jax.device_get(
        render(init_state(scene), pose, jnp.asarray(seeds))
    )
    assert int(done) == 7


def test_chunked_headless_until_noise_stops():
    """Explicit chunk > 1 composes with until_noise: the convergence stop
    checks between chunks instead of being silently skipped."""
    from terminal_raytracer.runtime.engine import Engine

    scene = load_scene("scene2").with_overrides(
        width=48, height=16, samples_per_pixel=4, max_depth=2
    )
    eng = Engine(scene, full_color=False, backend="jnp", deterministic=7)
    eng.run_headless(40, until_noise=1e9, chunk=4)
    assert eng.frame_count == 4  # stopped after the first chunk
