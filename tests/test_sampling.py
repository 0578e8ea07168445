"""Distribution tests for the Monte-Carlo samplers (chi-square / moment
checks per SURVEY.md §4.2)."""

import jax.numpy as jnp
import numpy as np

from terminal_raytracer.ops import rng as prng
from terminal_raytracer.ops import sampling
from terminal_raytracer.ops import vecmath as vm
from terminal_raytracer.ops.vecmath import V3


def _states(n, seed=1):
    return jnp.asarray((np.arange(n, dtype=np.uint32) * 2654435761 + seed).astype(np.uint32))


def _splat(vals, n):
    return V3(*(jnp.full((n,), v, jnp.float32) for v in vals))


N = 50_000


def test_orthonormal_basis():
    st = _states(1000)
    st, a = prng.next_f32(st)
    st, b = prng.next_f32(st)
    st, c = prng.next_f32(st)
    w = vm.normalize(V3(a - 0.5, b - 0.5, c - 0.5))
    u, v = sampling.orthonormal_basis(w)
    for pair in [(u, v), (u, w), (v, w)]:
        np.testing.assert_allclose(np.asarray(vm.dot(*pair)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(vm.dot(u, u)), 1.0, rtol=1e-5)
    # Right-handed: cross(w, u) == v
    cr = vm.cross(w, u)
    np.testing.assert_allclose(np.asarray(cr.x), np.asarray(v.x), atol=1e-5)


def test_cosine_hemisphere_moments():
    st = _states(N)
    normal = _splat([0.0, 0.0, 1.0], N)
    st, d = sampling.cosine_hemisphere(st, normal)
    cos_t = np.asarray(d.z)
    assert (cos_t >= -1e-6).all()  # upper hemisphere
    # pdf = cos/pi: E[cos] = 2/3, E[cos^2] = 1/2
    assert abs(cos_t.mean() - 2.0 / 3.0) < 0.01
    assert abs((cos_t**2).mean() - 0.5) < 0.01
    # Azimuthal symmetry
    assert abs(np.asarray(d.x).mean()) < 0.01
    assert abs(np.asarray(d.y).mean()) < 0.01


def test_cosine_hemisphere_chi_square_phi():
    st = _states(N, seed=9)
    normal = _splat([0.0, 1.0, 0.0], N)  # exercise the non-z ONB path
    st, d = sampling.cosine_hemisphere(st, normal)
    assert (np.asarray(d.y) >= -1e-6).all()
    phi = np.arctan2(np.asarray(d.z), np.asarray(d.x))
    hist, _ = np.histogram(phi, bins=16, range=(-np.pi, np.pi))
    expected = N / 16
    chi2 = ((hist - expected) ** 2 / expected).sum()
    assert chi2 < 2 * 16  # loose but catches broken azimuth


def test_sphere_light_uniform_on_surface():
    st = _states(N, seed=3)
    center = _splat([1.0, 2.0, 3.0], N)
    st, p, ln, area = sampling.sphere_light_point(st, center, 0.5)
    assert area == float(4.0 * sampling.PI * 0.25)
    r = np.sqrt(
        np.asarray((p.x - 1.0) ** 2 + (p.y - 2.0) ** 2 + (p.z - 3.0) ** 2)
    )
    np.testing.assert_allclose(r, 0.5, rtol=1e-5)
    # Uniform on sphere: mean position is the center; cos(theta) uniform
    assert abs(np.asarray(p.x).mean() - 1.0) < 0.01
    cos_t = np.asarray(p.z - 3.0) / 0.5
    hist, _ = np.histogram(cos_t, bins=10, range=(-1, 1))
    assert hist.min() > 0.9 * N / 10 * 0.8
    # light normal is the unit offset
    np.testing.assert_allclose(np.asarray(ln.x), np.asarray(p.x - 1.0) / 0.5, atol=1e-5)


def test_triangle_light_points_inside():
    st = _states(N, seed=5)
    v0 = _splat([0.0, 0.0, 0.0], N)
    v1 = _splat([2.0, 0.0, 0.0], N)
    v2 = _splat([0.0, 2.0, 0.0], N)
    st, p = sampling.triangle_light_point(st, v0, v1, v2)
    x, y, z = np.asarray(p.x), np.asarray(p.y), np.asarray(p.z)
    np.testing.assert_allclose(z, 0.0, atol=1e-6)
    assert (x >= -1e-6).all() and (y >= -1e-6).all()
    assert (x + y <= 2.0 + 1e-5).all()
    # Uniform over the triangle: centroid = (2/3, 2/3)
    assert abs(x.mean() - 2.0 / 3.0) < 0.01
    assert abs(y.mean() - 2.0 / 3.0) < 0.01
