import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.ops import vecmath as vm
from terminal_raytracer.ops.vecmath import V3


def _rand_v3(shape=(4, 5), seed=0):
    r = np.random.RandomState(seed)
    return V3(*(jnp.asarray(r.randn(*shape), jnp.float32) for _ in range(3)))


def test_add_sub_mul_div():
    a, b = _rand_v3(seed=1), _rand_v3(seed=2)
    c = a + b
    np.testing.assert_allclose(c.x, np.asarray(a.x) + np.asarray(b.x))
    d = a - b
    np.testing.assert_allclose(d.y, np.asarray(a.y) - np.asarray(b.y))
    e = a * 2.0
    np.testing.assert_allclose(e.z, np.asarray(a.z) * 2.0)
    h = a * b  # Hadamard
    np.testing.assert_allclose(h.x, np.asarray(a.x) * np.asarray(b.x))
    q = a / 4.0
    np.testing.assert_allclose(q.x, np.asarray(a.x) / 4.0)


def test_dot_cross_orthogonality():
    a, b = _rand_v3(seed=3), _rand_v3(seed=4)
    c = vm.cross(a, b)
    np.testing.assert_allclose(np.asarray(vm.dot(a, c)), 0.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(vm.dot(b, c)), 0.0, atol=1e-4)


def test_cross_handedness():
    x = V3(1.0, 0.0, 0.0)
    y = V3(0.0, 1.0, 0.0)
    z = vm.cross(x, y)
    assert (z.x, z.y, z.z) == (0.0, 0.0, 1.0)


def test_normalize_unit_length():
    a = _rand_v3(seed=5)
    n = vm.normalize(a)
    np.testing.assert_allclose(np.asarray(vm.dot(n, n)), 1.0, rtol=1e-5)


def test_reflect():
    # Reflecting a downward ray off an upward normal flips y.
    v = V3(jnp.float32(0.5), jnp.float32(-1.0), jnp.float32(0.25))
    n = V3(jnp.float32(0.0), jnp.float32(1.0), jnp.float32(0.0))
    r = vm.reflect(v, n)
    np.testing.assert_allclose([r.x, r.y, r.z], [0.5, 1.0, 0.25], rtol=1e-6)
    # Mirror property: |r| == |v|, and angle preserved.
    np.testing.assert_allclose(np.asarray(vm.dot(r, r)), np.asarray(vm.dot(v, v)), rtol=1e-6)


def test_where_and_components():
    a, b = _rand_v3(seed=6), _rand_v3(seed=7)
    mask = np.asarray(a.x) > 0
    w = vm.where(jnp.asarray(mask), a, b)
    np.testing.assert_allclose(w.x, np.where(mask, a.x, b.x))
    np.testing.assert_allclose(
        np.asarray(vm.max_component(a)),
        np.maximum(np.asarray(a.x), np.maximum(np.asarray(a.y), np.asarray(a.z))),
    )
    np.testing.assert_allclose(
        np.asarray(vm.sum_components(a)),
        np.asarray(a.x) + np.asarray(a.y) + np.asarray(a.z),
        rtol=1e-6,
    )


def test_min_components_nee_clamp():
    a = V3(jnp.float32(50.0), jnp.float32(3.0), jnp.float32(11.0))
    c = vm.min_components(a, 10.0)
    assert (float(c.x), float(c.y), float(c.z)) == (10.0, 3.0, 10.0)
