"""Cross-backend and cross-device agreement checks.

Two renders of one scene at the same seeds are compared on their decision
outputs -- per-pixel sample totals (the adaptive budget) and the frame's
ray count -- and on radiance. Both renders trace identical RNG chains, so
decisions agree exactly unless a float difference flips a branch:
transcendentals and fused multiply-adds differ between Triton, XLA:GPU and
XLA:CPU in the last bits, and at high depth such a difference can flip a
Russian-roulette or specular decision on an isolated pixel, which changes
that pixel's path and radiance. The checks therefore bound the SHARE of
pixels whose decisions differ, and judge radiance by the image mean and by
the error over pixels whose decisions agree. There is no matrix product on
this path (vecmath.dot is elementwise), so TF32 plays no part.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np

from ..models import Camera, scene as scene_mod


class Tolerance(NamedTuple):
    """Limits of one comparison (see the module docstring for why
    decisions may differ at all)."""

    budget_share: float  # share of pixels whose sample totals may differ
    rays_rel: float  # relative difference of the frame's ray count
    mean_rel: float  # relative difference of the image-mean radiance


# Each limit is about 10x the largest reading on an H100 (PERF.md lists the
# readings). A kernel block of 128 pixels lost or miswritten at north-star
# size is 1.6e-3 of the pixels, 8x the kernel-vs-jnp budget limit.
#
# Kernel vs jnp on one card (Triton vs XLA:GPU), north-star size, depth 32:
# read 1.25e-5 of pixels (one pixel), rays 2.19e-5, mean 8.35e-5.
KERNEL_VS_JNP = Tolerance(budget_share=2e-4, rays_rel=2e-4, mean_rel=1e-3)
# Card vs host CPU (two compilers, two instruction sets), 128x64, 16 spp,
# depth 8: read 1.22e-4 of pixels (one pixel), rays 2.77e-4, mean 1.02e-3.
CARD_VS_CPU = Tolerance(budget_share=2e-3, rays_rel=3e-3, mean_rel=1e-2)
# Kernel vs jnp on one card for the feature scenes of tests/test_gpu.py
# (grid and gathered traversals, normal map, sky texture), 200x100, 8 spp,
# depth 6: read at most 1.0e-4 of pixels (two pixels, bumpy), rays
# 9.73e-6, mean 3.57e-4 (bumpy).
FEATURE_SCENES = Tolerance(budget_share=1e-3, rays_rel=1e-4, mean_rel=4e-3)


def render_once(scene: scene_mod.Scene, backend: str, seed: int = 42,
                frame: int = 0, device=None, interpret: bool = False):
    """One frame's (radiance [3,H,W], sample totals [H,W], rays) on
    `device` (default: JAX's default device), as host arrays."""
    from ..ops import pallas_kernel
    from ..ops.tracer import PathTracer

    pose = Camera().pose()
    args = (pose, np.uint32(seed), np.int32(frame))
    if backend == "pallas":
        rf = pallas_kernel.make_render_frame(scene, interpret=interpret)
    else:
        rf = PathTracer(scene).render_frame
    if device is None:
        out = jax.jit(rf)(*args)
    else:
        with jax.default_device(device):
            out = jax.jit(rf)(*args)
    cur, _var, tot, rays = jax.device_get(out[:4])
    return np.stack([cur.x, cur.y, cur.z]), np.asarray(tot), float(rays)


def compare(a, b, tol: Tolerance) -> dict:
    """Compare two render_once results; `ok` says whether `tol` holds."""
    rad_a, tot_a, rays_a = a
    rad_b, tot_b, rays_b = b
    same = tot_a == tot_b
    diff = np.abs(rad_a - rad_b)
    mean_b = float(np.mean(rad_b))
    res = {
        "budget_mismatch_share": float(1.0 - np.mean(same)),
        "rays": [rays_a, rays_b],
        "rays_rel": abs(rays_a - rays_b) / max(abs(rays_b), 1.0),
        "max_abs": float(np.max(diff)),
        "max_abs_where_budgets_agree": float(
            np.max(diff[:, same]) if same.any() else 0.0),
        "mean_rel": abs(float(np.mean(rad_a)) - mean_b) / max(abs(mean_b),
                                                              1e-12),
    }
    res["ok"] = bool(
        np.all(np.isfinite(rad_a))
        and res["budget_mismatch_share"] <= tol.budget_share
        and res["rays_rel"] <= tol.rays_rel
        and res["mean_rel"] <= tol.mean_rel)
    return res
