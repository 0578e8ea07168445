"""Checkpoint/resume continuation semantics.

statefile.py promises "resuming restores progressive refinement exactly
where it stopped". These tests pin the actual continuation: after
--load-state, frame numbering resumes from the restored counter so the first
resumed frame blends into the loaded accumulation at alpha = 1/(k+1) instead
of overwriting it at alpha = 1 (the reference analog: frame_number feeds
shader.wgsl:612-620)."""

import numpy as np
import pytest

from terminal_raytracer.models import load_scene
from terminal_raytracer.runtime.engine import Engine
from terminal_raytracer.utils.statefile import load_state, save_state


def tiny_scene():
    return load_scene("scene2").with_overrides(
        width=32, height=12, samples_per_pixel=4, max_depth=2
    )


def make_engine(scene):
    return Engine(scene, backend="jnp", deterministic=7, verbose=False)


def test_headless_resume_continues_accumulation(tmp_path):
    scene = tiny_scene()

    # Continuous run: 3 frames in one engine.
    eng = make_engine(scene)
    eng.run_headless(2)
    mid_state, mid_count = eng.state, eng.frame_count
    path = tmp_path / "ckpt.npz"
    save_state(path, mid_state, mid_count, eng.camera)
    rgb_cont, _, _, _, _ = eng.run_headless(1)

    # Resumed run: restore the 2-frame checkpoint into a fresh engine,
    # advance its seed stream to the same position, render 1 more frame.
    eng2 = make_engine(scene)
    eng2.state, eng2.frame_count, eng2.camera = load_state(path)
    assert eng2.frame_count == 2
    for _ in range(eng2.frame_count):
        eng2._rng.randint(0, 2**32, dtype=np.uint64)
    rgb_res, _, _, _, _ = eng2.run_headless(1)

    # Exact continuation: identical to the uninterrupted run.
    np.testing.assert_array_equal(np.asarray(rgb_res), np.asarray(rgb_cont))
    assert eng2.frame_count == 3


def test_resume_does_not_overwrite_loaded_state(tmp_path):
    """The first resumed frame must NOT render with frame_number=0
    (alpha=1), which would discard the restored accumulation."""
    scene = tiny_scene()
    eng = make_engine(scene)
    eng.run_headless(4)
    path = tmp_path / "ckpt.npz"
    save_state(path, eng.state, eng.frame_count, eng.camera)
    loaded_acc = np.asarray(eng.state.acc)

    eng2 = make_engine(scene)
    eng2.state, eng2.frame_count, eng2.camera = load_state(path)
    eng2.run_headless(1)
    resumed_acc = np.asarray(eng2.state.acc)

    # A frame-number-0 render would replace acc outright; a frame-number-4
    # render blends at alpha=0.2, so the result stays close to the loaded
    # mean. Assert the blend weight is the continued one.
    fresh = make_engine(scene)
    fresh.run_headless(1)  # what frame_number=0 output looks like
    fresh_acc = np.asarray(fresh.state.acc)

    drift_cont = np.abs(resumed_acc - loaded_acc).mean()
    drift_overwrite = np.abs(fresh_acc - loaded_acc).mean()
    assert drift_cont < 0.5 * drift_overwrite


def test_scan_resume_matches_split_render():
    """Offline lax.scan path: scan(frame0=0, n=3) == scan(frame0=0, n=2)
    then scan(frame0=2, n=1) with the same per-frame seeds."""
    import jax

    from terminal_raytracer.runtime import init_state
    from terminal_raytracer.runtime.offline import make_scan_renderer

    scene = tiny_scene()
    from terminal_raytracer.models import Camera

    pose = Camera().pose()
    seeds = np.array([11, 22, 33], np.uint32)

    r3 = make_scan_renderer(scene, 3, full_color=True, backend="jnp")
    _, rgb_full, _, _ = r3(init_state(scene), pose, seeds)

    r2 = make_scan_renderer(scene, 2, full_color=True, backend="jnp")
    r1 = make_scan_renderer(scene, 1, full_color=True, backend="jnp")
    state, _, _, _ = r2(init_state(scene), pose, seeds[:2])
    _, rgb_split, _, _ = r1(state, pose, seeds[2:], np.int32(2))

    np.testing.assert_array_equal(
        np.asarray(jax.device_get(rgb_split)), np.asarray(jax.device_get(rgb_full))
    )


def test_run_headless_rejects_zero_frames():
    with pytest.raises(ValueError):
        make_engine(tiny_scene()).run_headless(0)
