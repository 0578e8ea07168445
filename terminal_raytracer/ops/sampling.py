"""Monte-Carlo direction and area sampling, vectorized over lanes.

Replicates the reference's samplers bit-for-bit in structure and constants:
cosine-weighted hemisphere with ONB-from-normal (reference:
src/shader.wgsl:312-335), uniform sphere-surface sampling and uniform
triangle-area sampling for NEE light points (shader.wgsl:352-389).

Per-lane divergent branches (the ONB axis pick) become `where` selects.
RNG draws happen in the same order as the reference so distributions match.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from . import rng as prng
from . import vecmath as vm
from .vecmath import V3

TWO_PI = 2.0 * 3.14159265359  # the shader's literal pi (shader.wgsl:318)
PI = 3.14159265359


def orthonormal_basis(w: V3) -> Tuple[V3, V3]:
    """(u, v) completing normalized w, shader.wgsl:324-332: u is built from
    the y-axis when |w.x| > 0.1, else from the x-axis."""
    use_y = jnp.abs(w.x) > 0.1
    # cross((0,1,0), w) = (w.z, 0, -w.x); cross((1,0,0), w) = (0, -w.z, w.y)
    u_y = vm.normalize(V3(w.z, jnp.zeros_like(w.z), -w.x))
    u_x = vm.normalize(V3(jnp.zeros_like(w.x), -w.z, w.y))
    u = vm.where(use_y, u_y, u_x)
    v = vm.cross(w, u)
    return u, v


def cosine_hemisphere(state, normal: V3, gate=None) -> Tuple[jnp.ndarray, V3]:
    """Cosine-weighted direction about `normal`; 2 RNG draws
    (shader.wgsl:312-335). Returns (state', direction). `gate`: see rng.next_f32
    — the reference draws these only on the diffuse branch (shader.wgsl:474)."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    cos_theta = jnp.sqrt(r1)
    sin_theta = jnp.sqrt(1.0 - r1)
    phi = TWO_PI * r2
    x = sin_theta * jnp.cos(phi)
    y = sin_theta * jnp.sin(phi)
    z = cos_theta
    w = vm.normalize(normal)
    u, v = orthonormal_basis(w)
    return state, vm.normalize(u * x + v * y + w * z)


def uniform_sphere_dir(state, gate=None) -> Tuple[jnp.ndarray, V3]:
    """Uniform direction on the unit sphere; 2 RNG draws.

    The metal-roughness fuzz vector (capability extension). The reference
    carries a rejection-sampled random_in_unit_sphere as dead code
    (shader.wgsl:117-124) — a rejection loop is the one shape a SIMD lane
    grid can't run, so the analytic inverse-CDF sphere point is used
    instead (the same math as sphere_light_point's local vector,
    shader.wgsl:352-360); fuzzing with a unit vector instead of an
    in-sphere point only rescales the effective roughness."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    cos_theta = 1.0 - 2.0 * r1
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    phi = TWO_PI * r2
    return state, V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi),
                     cos_theta)


def henyey_greenstein_dir(state, d: V3, g: float,
                          gate=None) -> Tuple[jnp.ndarray, V3]:
    """Henyey-Greenstein phase-function direction about the INCOMING unit
    direction `d`; 2 RNG draws. `g` is the static anisotropy in (-1, 1),
    g != 0 (g == 0 callers use uniform_sphere_dir — one fewer ONB).
    Standard inverse CDF: cos_t = (1 + g^2 - ((1-g^2)/(1-g+2gu))^2)/(2g).
    Sampling the phase exactly means a scattered path's throughput needs
    no phase weight at all (it cancels, like the cosine in
    cosine_hemisphere)."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    sq = (1.0 - g * g) / (1.0 - g + 2.0 * g * r1)
    cos_t = jnp.clip((1.0 + g * g - sq * sq) / (2.0 * g), -1.0, 1.0)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = TWO_PI * r2
    w = vm.normalize(d)
    u, v = orthonormal_basis(w)
    return state, (u * (sin_t * jnp.cos(phi)) + v * (sin_t * jnp.sin(phi))
                   + w * cos_t)


def fuzz_pdf(cos_r, roughness):
    """Solid-angle pdf of the metal fuzz lobe normalize(R + f*S), S the
    uniform_sphere_dir draw, about the perfect mirror axis R; `cos_r` is
    dot(direction, R) and `roughness` the per-lane f in [0, 1].

    The offset point R + f*S is uniform on a radius-f sphere centered at
    the unit point R, so the direction density is that sphere's area
    measure pushed through the projection: with c = 1 - f^2 and the
    ray-sphere discriminant D = cos_r^2 - c, the ray from the origin meets
    the sphere at depths t = cos_r -+ sqrt(D) and

        p(cos_r) = (t1^2 + t2^2) / (4 pi f sqrt(D))
                 = (2 cos_r^2 - c) / (2 pi f sqrt(D)),   cos_r >= sqrt(c),

    0 outside that cone. Closed form checked by its antiderivative
    b*sqrt(b^2 - c)/f, which integrates the lobe to exactly 1
    (test_roughness pins the histogram against the sampler). The
    integrable edge singularity (D -> 0) is floored; both 'mis' consumers
    (direct_light's NEE weight and the scatter-history pdf) evaluate this
    SAME guarded form, so their balance weights stay an exact partition
    of unity even where the floor bites. roughness == 0 lanes return 0 —
    the delta mirror lobe never enters a continuous pdf."""
    c = 1.0 - roughness * roughness
    disc = cos_r * cos_r - c
    inside = (cos_r > 0.0) & (disc > 1e-9) & (roughness > 0.0)
    denom = 2.0 * PI * roughness * jnp.sqrt(jnp.maximum(disc, 1e-9))
    return jnp.where(
        inside, (2.0 * cos_r * cos_r - c) / jnp.maximum(denom, 1e-20), 0.0
    )


def hg_phase(cos_t, g: float):
    """The Henyey-Greenstein phase function value p(cos theta) — the
    per-steradian scattering density NEE evaluates toward a sampled light
    (g = 0 reduces to the isotropic 1/4pi)."""
    g2 = g * g
    denom = 1.0 + g2 - 2.0 * g * cos_t
    return (1.0 - g2) / (
        4.0 * PI * denom * jnp.sqrt(jnp.maximum(denom, 1e-12))
    )


def atan2(y, x):
    """Branchless polynomial atan2 for the texture uv mapping: the SAME
    jnp-primitive code runs in the oracle and the GPU kernel, parity by
    construction (a native atan2 is ROADMAP D2).

    Octant reduction to a = min/max of |x|,|y| in [0, 1], then a degree-9
    odd minimax polynomial for atan(a) (max abs error ~1e-5 rad — a texel
    knife-edge far finer than the 8-bit texel grid), then the standard
    quadrant unfolds. atan2(0, 0) returns 0. NOT a drop-in libm atan2 —
    accuracy is sized for texture addressing, nothing else consumes it."""
    ax, ay = jnp.abs(x), jnp.abs(y)
    hi = jnp.maximum(ax, ay)
    a = jnp.minimum(ax, ay) / jnp.where(hi > 0.0, hi, 1.0)
    s = a * a
    r = a * (0.99997726 + s * (-0.33262347 + s * (0.19354346 + s * (
        -0.11643287 + s * (0.05265332 - s * 0.01172120)))))
    r = jnp.where(ay > ax, 0.5 * PI - r, r)
    r = jnp.where(x < 0.0, PI - r, r)
    return jnp.where(y < 0.0, -r, r)


def sphere_light_point(state, center: V3, radius, gate=None) -> Tuple[jnp.ndarray, V3, V3, float]:
    """Uniform point on a sphere light; 2 RNG draws (shader.wgsl:352-369).

    Returns (state', point, light_normal, area). The reference's "local
    point" is a world-axis-aligned unit vector (no frame alignment)."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    cos_theta = 1.0 - 2.0 * r1
    sin_theta = jnp.sqrt(1.0 - cos_theta * cos_theta)
    phi = TWO_PI * r2
    local = V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta)
    point = center + local * radius
    area = 4.0 * PI * radius * radius
    return state, point, local, area


def triangle_light_point(state, v0: V3, v1: V3, v2: V3, gate=None) -> Tuple[jnp.ndarray, V3]:
    """Uniform point on a triangle light; 2 RNG draws (shader.wgsl:370-384).
    The caller supplies the (precomputed, constant) normal and area."""
    state, r1, r2 = prng.next_f32_pair(state, gate)
    sqrt_r1 = jnp.sqrt(r1)
    u = 1.0 - sqrt_r1
    v = r2 * sqrt_r1
    point = v0 * (1.0 - u - v) + v1 * u + v2 * v
    return state, point
