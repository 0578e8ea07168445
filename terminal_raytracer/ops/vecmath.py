"""SoA 3-vector math on component triples.

Representation choice: a 3-vector *field* over a lane grid is three
separate arrays (x, y, z), each of the full lane shape — never a trailing
dim-3 axis, so every elementwise op stays dense over the lanes (one value
per lane per register in the GPU kernel). This replaces the reference's 16-byte padded AoS ``Vec3``
(reference: src/vec3.rs:5-12), which exists only for WGSL struct ABI reasons.

All functions are shape-polymorphic pure ``jax.numpy``: lanes may be a
1-D ray batch, an (H, W) image, or an (8, 128) Pallas tile. Components may
also be Python floats (broadcast scalars) — which is how static scene
geometry is baked into kernels.

Semantics mirror the reference's vector helpers (src/vec3.rs:24-86,
src/shader.wgsl:83-140, 225-232).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

Scalar = Union[float, jnp.ndarray]


class V3(NamedTuple):
    """A 3-vector (or field of 3-vectors) as three same-shaped components."""

    x: Scalar
    y: Scalar
    z: Scalar

    def __add__(self, o: "V3") -> "V3":
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "V3") -> "V3":
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o: Union["V3", Scalar]) -> "V3":
        if isinstance(o, V3):  # Hadamard, like shader.wgsl:95-97 vec3_mul_vec3
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, s: Scalar) -> "V3":
        return V3(self.x / s, self.y / s, self.z / s)

    def __neg__(self) -> "V3":
        return V3(-self.x, -self.y, -self.z)


def v3(x: Scalar, y: Scalar, z: Scalar) -> V3:
    return V3(x, y, z)


def splat(c: Scalar) -> V3:
    return V3(c, c, c)


def _is_const(v, value: float) -> bool:
    return isinstance(v, (int, float)) and float(v) == value


def _smul(a, b):
    """Trace-time-folding multiply: scene geometry is baked as Python-float
    constants (models/scene.py), and axis-aligned data is full of exact
    0/±1 components — folding them here removes real ops at trace time,
    whatever the compiler downstream would fold. Folding
    0*x -> 0 also short-circuits NaN/Inf from masked dead lanes, which is
    the safe direction (every consumer is mask-selected)."""
    if _is_const(a, 0.0) or _is_const(b, 0.0):
        return 0.0
    if _is_const(a, 1.0):
        return b
    if _is_const(b, 1.0):
        return a
    if _is_const(a, -1.0):
        return -b
    if _is_const(b, -1.0):
        return -a
    return a * b


def _sadd(a, b):
    if _is_const(a, 0.0):
        return b
    if _is_const(b, 0.0):
        return a
    return a + b


def _ssub(a, b):
    if _is_const(b, 0.0):
        return a
    if _is_const(a, 0.0):
        return -b
    return a - b


def dot(a: V3, b: V3) -> Scalar:
    """shader.wgsl:126-128 (with trace-time constant folding)."""
    return _sadd(_sadd(_smul(a.x, b.x), _smul(a.y, b.y)), _smul(a.z, b.z))


def cross(a: V3, b: V3) -> V3:
    """shader.wgsl:225-232 (with trace-time constant folding)."""
    return V3(
        _ssub(_smul(a.y, b.z), _smul(a.z, b.y)),
        _ssub(_smul(a.z, b.x), _smul(a.x, b.z)),
        _ssub(_smul(a.x, b.y), _smul(a.y, b.x)),
    )


def length(a: V3) -> Scalar:
    """shader.wgsl:130-132."""
    return jnp.sqrt(dot(a, a))


def normalize(a: V3) -> V3:
    """shader.wgsl:134-136. Uses rsqrt (one op) instead of sqrt+div."""
    inv = jax.lax.rsqrt(dot(a, a))
    return a * inv


def reflect(v: V3, n: V3) -> V3:
    """Mirror reflection, shader.wgsl:138-140."""
    return v - n * (2.0 * dot(v, n))


def where(mask, a: V3, b: V3) -> V3:
    """Per-lane select of whole vectors. The masking primitive of the
    wavefront tracer: every divergent `break`/`if` in the reference kernel
    becomes one of these."""
    return V3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def max_component(a: V3) -> Scalar:
    """max(att.x, max(att.y, att.z)) as in Russian roulette, shader.wgsl:486."""
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def sum_components(a: V3) -> Scalar:
    return a.x + a.y + a.z


def clamp(a: V3, lo: Scalar, hi: Scalar) -> V3:
    return V3(
        jnp.clip(a.x, lo, hi),
        jnp.clip(a.y, lo, hi),
        jnp.clip(a.z, lo, hi),
    )


def min_components(a: V3, cap: Scalar) -> V3:
    """Per-channel min against a scalar (NEE clamp, shader.wgsl:420-427)."""
    return V3(
        jnp.minimum(a.x, cap), jnp.minimum(a.y, cap), jnp.minimum(a.z, cap)
    )


def full_like(ref: jnp.ndarray, xyz) -> V3:
    """Broadcast a concrete (x, y, z) triple to the lane shape of `ref`."""
    return V3(
        jnp.full_like(ref, xyz[0]),
        jnp.full_like(ref, xyz[1]),
        jnp.full_like(ref, xyz[2]),
    )
