"""Counter-based PCG-hash RNG, vectorized over lane grids.

The reference kernel uses a per-invocation ``var<private> rand_state: u32``
advanced by a PCG output hash (reference: src/shader.wgsl:104-115), seeded
per pixel as ``(y*w + x)*1973 + seed*9277 + frame*12345`` (shader.wgsl:507)
and re-hashed per sample with ``pcg_hash(state + i*5096)`` (shader.wgsl:517).

Here the state is an explicit ``uint32`` array of the lane shape, threaded
functionally through the tracer. This is deliberately *not* jax.random
(threefry): threefry costs dozens of rounds per draw, while this hash is a
handful of integer ops — and it reproduces the reference's statistics
and decorrelation structure exactly. Per-pixel bit-parity with the reference
is impossible anyway (the reference draws data-dependently inside divergent
control flow; the wavefront tracer draws in fixed order), hence "parity
modulo RNG" (PARITY.md).

Works identically in pure jax.numpy and inside the GPU kernel (uint32
arithmetic wraps mod 2**32 in both).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

_U32 = jnp.uint32

# 1 / (2**32 - 1): the reference maps u32 -> f32 by dividing by 4294967295.0
# (shader.wgsl:112-115).
_INV_U32_MAX = float(1.0 / 4294967295.0)


def u32_to_f32(v: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 value conversion, written as int32 + wraparound
    correction (ROADMAP D2: an earlier accelerator lacked the direct cast).
    Used on every backend so oracle and kernel stay bit-identical. Differs
    from a native round(u32) by at most one ulp (double rounding for values
    >= 2^31), far below Monte-Carlo relevance."""
    i = v.astype(jnp.int32)
    f = i.astype(jnp.float32)
    return jnp.where(i < 0, f + jnp.float32(4294967296.0), f)


def pcg_hash(x: jnp.ndarray) -> jnp.ndarray:
    """PCG-XSH-RR style output hash; bit-exact vs shader.wgsl:106-110."""
    x = x.astype(_U32)
    state = x * _U32(747796405) + _U32(2891336453)
    word = ((state >> ((state >> _U32(28)) + _U32(4))) ^ state) * _U32(277803737)
    return (word >> _U32(22)) ^ word


def seed_pixel(
    pixel_index: jnp.ndarray, seed: jnp.ndarray, frame_number: jnp.ndarray
) -> jnp.ndarray:
    """Per-pixel initial state; bit-exact vs shader.wgsl:507.

    ``pixel_index`` is ``y*width + x`` of the lane shape; ``seed`` and
    ``frame_number`` are (traced) scalars.
    """
    return (
        pixel_index.astype(_U32) * _U32(1973)
        + seed.astype(_U32) * _U32(9277)
        + frame_number.astype(_U32) * _U32(12345)
    )


def advance_sample(
    state: jnp.ndarray, sample_index: jnp.ndarray, gate=None
) -> jnp.ndarray:
    """Per-sample decorrelation re-hash; bit-exact vs shader.wgsl:517,565.
    `gate` as in :func:`next_f32` (the adaptive extra-sample loop re-hashes
    only on pixels actually taking extra samples, shader.wgsl:561-565)."""
    i = jnp.asarray(sample_index).astype(_U32)
    new = pcg_hash(state + i * _U32(5096))
    if gate is not None:
        new = jnp.where(gate, new, state)
    return new


def next_f32(state: jnp.ndarray, gate=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One uniform draw in [0, 1]; state' = pcg_hash(state), value = state'/(2^32-1).

    Matches random_f32 (shader.wgsl:112-115): note the reference advances the
    state *first* and converts the new state.

    `gate` (bool lanes, optional) emulates the reference's *data-dependent*
    draw counts under SIMD: where gate is False, the lane's state does not
    advance — exactly as a scalar GPU thread that branched around this
    ``random_f32()`` call would keep its state. With every draw gated by the
    reference's control-flow condition, each lane's RNG chain is bit-identical
    to the reference thread's, making same-seed parity tests exact.
    (The drawn value is still produced for gated-off lanes; callers mask its
    use.)
    """
    new = pcg_hash(state)
    value = u32_to_f32(new) * jnp.float32(_INV_U32_MAX)
    if gate is not None:
        new = jnp.where(gate, new, state)
    return new, value


def next_f32_pair(
    state: jnp.ndarray, gate=None
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    state, a = next_f32(state, gate)
    state, b = next_f32(state, gate)
    return state, a, b
