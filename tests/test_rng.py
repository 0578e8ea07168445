"""PCG hash bit-exactness (vs an independent NumPy implementation of
shader.wgsl:104-115), statistical quality, and draw gating."""

import jax.numpy as jnp
import numpy as np

from terminal_raytracer.ops import rng as prng

from scalar_ref import Rng


def test_pcg_hash_bit_exact_vs_numpy():
    xs = np.array([0, 1, 2, 12345, 0xDEADBEEF, 0xFFFFFFFF], np.uint32)
    ours = np.asarray(prng.pcg_hash(jnp.asarray(xs)))
    theirs = np.array([Rng.hash(x) for x in xs], np.uint32)
    np.testing.assert_array_equal(ours, theirs)


def test_next_f32_matches_scalar_chain():
    state = jnp.full((8,), 777, jnp.uint32)
    r = Rng(777)
    for _ in range(10):
        state, v = prng.next_f32(state)
        expected = r.f32()
        np.testing.assert_allclose(np.asarray(v), expected, rtol=1e-7)


def test_seed_pixel_formula():
    # (y*w + x)*1973 + seed*9277 + frame*12345, wrapping u32 (shader.wgsl:507)
    pix = jnp.asarray(np.array([0, 1, 99999], np.uint32))
    s = prng.seed_pixel(pix, jnp.uint32(7), jnp.uint32(3))
    with np.errstate(over="ignore"):
        expected = (
            np.array([0, 1, 99999], np.uint32) * np.uint32(1973)
            + np.uint32(7) * np.uint32(9277)
            + np.uint32(3) * np.uint32(12345)
        )
    np.testing.assert_array_equal(np.asarray(s), expected)


def test_uniformity():
    state = jnp.arange(100_000, dtype=jnp.uint32) * jnp.uint32(1973)
    state, v = prng.next_f32(state)
    v = np.asarray(v)
    assert abs(v.mean() - 0.5) < 0.01
    assert abs(v.var() - 1.0 / 12.0) < 0.005
    hist, _ = np.histogram(v, bins=16, range=(0, 1))
    assert hist.min() > 0.8 * len(v) / 16  # no empty-ish bins


def test_gated_draws_freeze_state():
    state = jnp.asarray(np.array([5, 6, 7, 8], np.uint32))
    gate = jnp.asarray(np.array([True, False, True, False]))
    new, _ = prng.next_f32(state, gate)
    new = np.asarray(new)
    assert new[1] == 6 and new[3] == 8  # gated-off lanes unchanged
    assert new[0] != 5 and new[2] != 7


def test_advance_sample_gate():
    state = jnp.asarray(np.array([11, 12], np.uint32))
    gate = jnp.asarray(np.array([False, True]))
    new = prng.advance_sample(state, jnp.int32(3), gate)
    assert int(new[0]) == 11
    with np.errstate(over="ignore"):
        assert int(new[1]) == int(Rng.hash(np.uint32(12 + 3 * 5096)))
