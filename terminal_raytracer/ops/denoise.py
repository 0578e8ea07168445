"""Edge-aware à-trous denoiser over the accumulated radiance.

A capability extension (the reference ships no reconstruction filter —
its only noise control is more samples, reference: src/shader.wgsl:499-602
adaptive sampling + src/lib.rs:612-620 temporal accumulation). This adds
the modern wavelet reconstruction step those pipelines feed: an à-trous
(holey) B3-spline filter with VARIANCE-GUIDED color edge-stopping — the
SVGF family's spatial pass (Dammertz et al. 2010, Schied et al. 2017)
adapted to what this renderer already has on device:

* guidance comes from the per-pixel sample variance the adaptive sampler
  already computes (FrameState.variance), scaled to the variance OF THE
  ACCUMULATED MEAN (var / total samples — the same convergence estimate
  `--until-noise` checks, runtime/offline.py noise_of): where the image
  is still noisy the color edge-stop relaxes (differences are probably
  noise); as accumulation converges the guidance shrinks, the edge-stop
  tightens, and the filter backs off toward the identity — the render
  converges to the UNFILTERED ground truth. No G-buffer is needed (the
  tracer keeps no normal/depth planes by design — the uint8-readback
  transfer contract, SURVEY.md §5.8).
* the filter is a POST-PROCESS between temporal accumulation and
  tonemapping: the estimator, its RNG chains, ray counts and the
  accumulated state are untouched (checkpoints stay raw), so every
  parity/decision invariant holds verbatim — `--denoise 0` (the default)
  compiles the exact pre-extension program.
* Formulation: each à-trous tap is a static pad+slice shift (jnp.roll
  with edge clamp) fused by XLA into the render step's epilogue — 25
  taps x `passes` rounds over (H, W) planes, all elementwise work, no
  gathers, no data-dependent shapes.

Weights per tap q around p (stride s doubles each pass):

    w = h(q) * exp(-||c_p - c_q||^2 / (k^2 * (var_p + var_q + eps)))

with h the separable B3-spline (1/16, 1/4, 3/8, 1/4, 1/16) and k the
user strength (--denoise K; larger = smoother). The variance plane is
re-estimated between passes as var' = sum(w^2 var_q) / (sum w)^2 — the
SVGF variance propagation, so later (wider) passes stop on edges the
earlier passes sharpened.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .vecmath import V3

# Separable B3-spline taps (Dammertz et al. 2010).
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
_VAR_EPS = 1e-4


def _shift(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift a (H, W) plane by (dy, dx) with clamped (edge-replicate)
    boundaries — static slicing only."""
    h, w = a.shape
    if dy:
        if dy > 0:
            a = jnp.concatenate(
                [jnp.repeat(a[:1, :], dy, axis=0), a[:-dy, :]], axis=0)
        else:
            a = jnp.concatenate(
                [a[-dy:, :], jnp.repeat(a[-1:, :], -dy, axis=0)], axis=0)
    if dx:
        if dx > 0:
            a = jnp.concatenate(
                [jnp.repeat(a[:, :1], dx, axis=1), a[:, :-dx]], axis=1)
        else:
            a = jnp.concatenate(
                [a[:, -dx:], jnp.repeat(a[:, -1:], -dx, axis=1)], axis=1)
    return a


def _shift_v3(c: V3, dy: int, dx: int) -> V3:
    return V3(_shift(c.x, dy, dx), _shift(c.y, dy, dx), _shift(c.z, dy, dx))


def atrous_pass(color: V3, var: jnp.ndarray, stride: int, k: float):
    """One à-trous round at the given tap stride. Returns (color', var')."""
    inv = 1.0 / (k * k)
    wsum = jnp.zeros_like(var)
    csum = V3(jnp.zeros_like(var), jnp.zeros_like(var), jnp.zeros_like(var))
    vsum = jnp.zeros_like(var)
    for iy, hy in enumerate(_B3):
        for ix, hx in enumerate(_B3):
            dy = (iy - 2) * stride
            dx = (ix - 2) * stride
            h = hy * hx
            cq = _shift_v3(color, dy, dx)
            vq = _shift(var, dy, dx)
            d2 = ((color.x - cq.x) ** 2 + (color.y - cq.y) ** 2
                  + (color.z - cq.z) ** 2)
            w = h * jnp.exp(-d2 * inv / (var + vq + _VAR_EPS))
            wsum = wsum + w
            csum = csum + cq * w
            vsum = vsum + w * w * vq
    inv_w = 1.0 / jnp.maximum(wsum, 1e-12)
    return csum * inv_w, vsum * (inv_w * inv_w)


def denoise(color: V3, var: jnp.ndarray, strength: float,
            passes: int = 3) -> V3:
    """Filter the accumulated radiance. `var` is the variance of the
    accumulated per-pixel MEAN (sample variance / total samples — see
    denoise_acc; clamped at 0 here, the reference keeps the raw plane
    possibly slightly negative). strength <= 0 is the identity (callers
    gate statically)."""
    if strength <= 0.0 or passes <= 0:
        return color
    # Variance has radiance^2 units — the same units as the squared color
    # differences — so the edge-stop ratio is dimensionless and
    # scene-scale-invariant with no extra normalization. As accumulation
    # converges the guidance shrinks: flat-region differences fall with
    # it (w -> h: harmless smoothing) while true edges keep their
    # contrast against it (w -> 0: preserved), and once var << d2 at
    # every neighbor the filter is the identity — it removes itself as
    # the estimator converges.
    v = jnp.maximum(var, 0.0)
    for p in range(passes):
        color, v = atrous_pass(color, v, 1 << p, float(strength))
    return color


def denoise_acc(acc: V3, variance: jnp.ndarray, samples: jnp.ndarray,
                frame_number, strength: float, passes: int = 3) -> V3:
    """The render-step entry point: filter the accumulated radiance
    guided by the variance of its mean. `variance`/`samples` are the
    last frame's FrameState planes (per-sample variance, samples taken);
    the accumulation over `frame_number + 1` frames has mean-variance
    ~ variance / (samples * frames) — the same convergence estimate the
    --until-noise stop checks (runtime/offline.py noise_of). Static
    identity at strength <= 0 (the default compiles the exact
    pre-extension program)."""
    if strength <= 0.0 or passes <= 0:
        return acc
    fn = jnp.asarray(frame_number, jnp.float32)
    total = samples * (fn + 1.0)
    return denoise(acc, variance / jnp.maximum(total, 1.0),
                   strength, passes)


# ----------------------------------------------------------------------
# Multi-chip: the filter under pixel-row sharding (parallel/mesh.py).
# Each à-trous tap reaches 2*stride rows — across shard boundaries under
# 'px' row sharding — so each pass first exchanges halo rows with the
# NEIGHBOR shards (jax.lax.ppermute; global edges replicate,
# matching the single-chip edge clamp), runs the pass on the padded
# block, and keeps the center. Bit-identical to the single-chip filter:
# the center rows see exactly the rows the full-image shifts would.
# When the widest pass's halo would not fit in one neighbor's block
# (tiny shards), one all_gather of the planes runs the single-chip
# filter instead — same result, simpler traffic.
# ----------------------------------------------------------------------


def _exchange_halo(a: jnp.ndarray, halo: int, axis_name: str,
                   n_shards: int) -> jnp.ndarray:
    """Pad a (rows, W) shard block to (rows + 2*halo, W) with neighbor
    rows along the sharded row axis (global edges edge-replicate)."""
    fwd = [(i, i + 1) for i in range(n_shards - 1)]
    bwd = [(i + 1, i) for i in range(n_shards - 1)]
    from_above = jax.lax.ppermute(a[-halo:, :], axis_name, fwd)
    from_below = jax.lax.ppermute(a[:halo, :], axis_name, bwd)
    idx = jax.lax.axis_index(axis_name)
    top = jnp.where(idx == 0, jnp.repeat(a[:1, :], halo, axis=0),
                    from_above)
    bot = jnp.where(idx == n_shards - 1,
                    jnp.repeat(a[-1:, :], halo, axis=0), from_below)
    return jnp.concatenate([top, a, bot], axis=0)


def denoise_sharded(color: V3, var: jnp.ndarray, strength: float,
                    passes: int, axis_name: str, n_shards: int) -> V3:
    """`denoise` for (rows, W) blocks sharded along `axis_name` (must be
    called inside shard_map). Returns the filtered local block —
    bit-identical to slicing the single-chip filter of the full image."""
    if strength <= 0.0 or passes <= 0:
        return color
    if n_shards == 1:
        return denoise(color, var, strength, passes)
    rows = color.x.shape[0]
    halo_max = 2 * (1 << (passes - 1))
    v = jnp.maximum(var, 0.0)
    if halo_max > rows:
        # Halos would span multiple shards: gather the full planes (tiny —
        # the whole image is a terminal) and slice our block back.
        def gather(p):
            return jax.lax.all_gather(p, axis_name, tiled=True)

        full = denoise(V3(gather(color.x), gather(color.y),
                          gather(color.z)), gather(v), strength, passes)
        r0 = jax.lax.axis_index(axis_name) * rows

        def take(p):
            return jax.lax.dynamic_slice_in_dim(p, r0, rows, axis=0)

        return V3(take(full.x), take(full.y), take(full.z))
    for p in range(passes):
        stride = 1 << p
        halo = 2 * stride
        padded = V3(
            _exchange_halo(color.x, halo, axis_name, n_shards),
            _exchange_halo(color.y, halo, axis_name, n_shards),
            _exchange_halo(color.z, halo, axis_name, n_shards),
        )
        c_p, v_p = atrous_pass(
            padded, _exchange_halo(v, halo, axis_name, n_shards),
            stride, float(strength))
        sl = slice(halo, halo + rows)
        color = V3(c_p.x[sl], c_p.y[sl], c_p.z[sl])
        v = v_p[sl]
    return color


def denoise_acc_sharded(acc: V3, variance: jnp.ndarray,
                        samples: jnp.ndarray, frame_number,
                        strength: float, passes: int, axis_name: str,
                        n_shards: int) -> V3:
    """`denoise_acc` for the sharded render step (parallel/mesh.py)."""
    if strength <= 0.0 or passes <= 0:
        return acc
    fn = jnp.asarray(frame_number, jnp.float32)
    total = samples * (fn + 1.0)
    return denoise_sharded(acc, variance / jnp.maximum(total, 1.0),
                           strength, passes, axis_name, n_shards)
