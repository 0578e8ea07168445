"""Race-detection equivalents (SURVEY.md §5.2): JAX's functional model
removes buffer races by construction; these tests pin the remaining
invariants — finite math under jax_debug_nans, donation correctness, and
deterministic replay."""

import jax
import jax.numpy as jnp
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.runtime import init_state, make_render_step

POSE = Camera().pose()


def _scene():
    return load_scene("Cornell_Box").with_overrides(
        width=32, height=16, samples_per_pixel=4, max_depth=6
    )


def test_no_nans_under_debug_nans():
    """jax_debug_nans raises on any NaN produced anywhere in the step —
    including intermediate values (masked dead-lane math must stay finite
    enough that XLA doesn't materialize NaNs into outputs)."""
    scene = _scene()
    with jax.debug_nans(True):
        step = make_render_step(scene, backend="jnp")
        out = step(init_state(scene), POSE, np.uint32(3), np.int32(0))
        assert np.isfinite(np.asarray(out.state.acc)).all()


def test_donation_correctness():
    """The donated state buffer must not corrupt results: a donated chain
    gives the same pixels as a non-donated (jit=False) chain."""
    scene = _scene()
    donated = make_render_step(scene, backend="jnp", jit=True)
    plain = make_render_step(scene, backend="jnp", jit=False)
    s1, s2 = init_state(scene), init_state(scene)
    for f in range(3):
        o1 = donated(s1, POSE, np.uint32(10 + f), np.int32(f))
        o2 = plain(s2, POSE, np.uint32(10 + f), np.int32(f))
        s1, s2 = o1.state, o2.state
    np.testing.assert_allclose(
        np.asarray(s1.acc), np.asarray(s2.acc), atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(o1.rgb), np.asarray(o2.rgb))


def test_deterministic_replay():
    """Fixed seeds => bit-identical frames across independent runs (the
    race-equivalent invariant: any scheduling nondeterminism would show)."""
    scene = _scene()
    imgs = []
    for _ in range(2):
        step = make_render_step(scene, backend="jnp")
        state = init_state(scene)
        for f in range(2):
            out = step(state, POSE, np.uint32(40 + f), np.int32(f))
            state = out.state
        imgs.append(np.asarray(out.rgb))
    np.testing.assert_array_equal(imgs[0], imgs[1])
