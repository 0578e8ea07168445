"""Blocked primitive order -- the consumption of the reference's dead
uniform grid (SURVEY.md §2.4) by block culling.

Parity context: the reference *builds and uploads* a uniform grid
(reference: src/lib.rs:158-246) that its shader never reads -- traversal is
brute-force linear (shader.wgsl:254). ops/grid.py reproduces that build-time
artifact; this module orders the primitives for an acceleration structure
that skips *whole blocks of primitives for a whole block of rays at once*:
a ray/AABB slab test reduced with `any()` guards each block's sweep.
Spatially sorting primitives (Morton order of their AABB centroids, boxes
from ops/grid.py `primitive_aabbs`) makes blocks compact.

Semantics are EXACTLY brute-force linear over the blocked primitive order:
a culled block's AABB contains all its primitives, so a ray whose
[t_min, closest) interval misses the box cannot find a closer hit inside --
skipping is output-invariant.

Reordering happens within each primitive *type* group (the scene flatten
order is spheres, planes, triangles -- lib.rs:120-154), with emissive
primitives kept first in their original relative order so the NEE light
list (and therefore every RNG gate) is untouched. Planes are never blocked
(infinite extent; the reference's grid gives them degenerate AABBs too,
lib.rs:177).

Status: the guarded sweep ran only as a scratch-ref form of the earlier
accelerator's kernel, where it lost to the brute sweep (decorrelated
wavefront rays hit nearly every block's box). Both the XLA path and the
GPU kernel now sweep the blocked order densely (`CulledPrims`), so
`--accel grid` gives the brute result in another order; a per-block
`lax.cond` guard inside the GPU kernel is the open experiment (ROADMAP
S6).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..models import scene as scene_mod
from . import geometry as geom
from .vecmath import V3

BLOCK = 8

# Pad primitives parked far outside every real block AABB: they can never
# hit within T_FAR and never widen a block's box (boxes span real members
# only).
_PAD_POS = 1.0e30

_BIG = 3.0e38  # slab-test sentinel (< f32 inf; avoids inf*0 NaN paths)


def _part1by2(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits: b9..b0 -> every third bit position."""
    v = v.astype(np.uint64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3(cx: np.ndarray, cy: np.ndarray, cz: np.ndarray) -> np.ndarray:
    """30-bit Morton code from 10-bit cell coordinates."""
    return _part1by2(cx) | (_part1by2(cy) << 1) | (_part1by2(cz) << 2)


def _centroid_cells(boxes: np.ndarray) -> np.ndarray:
    """Quantize AABB centroids to a 1024^3 lattice over the scene bbox."""
    cen = boxes.mean(axis=1)
    lo = cen.min(axis=0)
    span = np.maximum(cen.max(axis=0) - lo, 1e-12)
    q = np.clip(((cen - lo) / span) * 1023.0, 0.0, 1023.0).astype(np.uint64)
    return q


@dataclasses.dataclass(frozen=True)
class _Group:
    """One sweep unit: a sublist of (tag, prim) in dense order, plus its
    AABB (None = unguarded, always swept — planes)."""

    prims: tuple
    aabb: Optional[Tuple[Tuple[float, float, float],
                         Tuple[float, float, float]]]


def _pad_sphere() -> scene_mod.Sphere:
    mat = scene_mod.Material(color=(0.0, 0.0, 0.0), emission=(0.0, 0.0, 0.0),
                             reflectivity=0.0)
    return scene_mod.Sphere(center=(_PAD_POS, _PAD_POS, _PAD_POS),
                            radius=1.0, material=mat)


def _pad_triangle() -> scene_mod.Triangle:
    mat = scene_mod.Material(color=(0.0, 0.0, 0.0), emission=(0.0, 0.0, 0.0),
                             reflectivity=0.0)
    p = (_PAD_POS, _PAD_POS, _PAD_POS)
    return scene_mod.Triangle(v0=p, v1=p, v2=p, material=mat)


def _order_group(prims: list) -> list:
    """Emissive primitives first (original relative order — the NEE light
    list and its RNG gates depend on it), the rest Morton-ordered."""
    lights = [p for p in prims if p.material.is_light]
    rest = [p for p in prims if not p.material.is_light]
    if len(rest) > 1:
        tagged = [(scene_mod.SPHERE if isinstance(p, scene_mod.Sphere)
                   else scene_mod.TRIANGLE, p) for p in rest]
        boxes = []
        for tag, p in tagged:
            if tag == scene_mod.SPHERE:
                c = np.asarray(p.center, np.float32)
                r = np.float32(p.radius)
                boxes.append((c - r, c + r))
            else:
                v = np.stack([p.v0, p.v1, p.v2]).astype(np.float32)
                boxes.append((v.min(0), v.max(0)))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 2, 3)
        cells = _centroid_cells(boxes)
        codes = morton3(cells[:, 0], cells[:, 1], cells[:, 2])
        order = np.argsort(codes, kind="stable")
        rest = [rest[i] for i in order]
    return lights + rest


def _block_aabb(tag: int, members: list):
    """(lo, hi) python-float tuples over the block's real members."""
    boxes = []
    for p in members:
        if tag == scene_mod.SPHERE:
            c = np.asarray(p.center, np.float64)
            boxes.append((c - float(p.radius), c + float(p.radius)))
        else:
            v = np.stack([p.v0, p.v1, p.v2]).astype(np.float64)
            boxes.append((v.min(0), v.max(0)))
    lo = np.min([b[0] for b in boxes], axis=0)
    hi = np.max([b[1] for b in boxes], axis=0)
    # Small epsilon pad against f32 rounding in the slab test.
    eps = 1e-4 + 1e-5 * np.maximum(np.abs(lo), np.abs(hi))
    lo, hi = lo - eps, hi + eps
    return (tuple(float(v) for v in lo), tuple(float(v) for v in hi))


def blocked_scene(scene: scene_mod.Scene, block: int = BLOCK):
    """Reorder + pad a scene for block culling.

    Returns (scene2, groups): scene2 is the same scene with spheres and
    triangles type-locally reordered (lights first, rest Morton) and padded
    to a block multiple; groups is the dense sweep decomposition —
    guarded sphere blocks, unguarded planes, guarded triangle blocks — in
    scene2's flatten order."""
    spheres = _order_group(list(scene.spheres))
    triangles = _order_group(list(scene.triangles))

    def padded(prims, mk_pad):
        if not prims:
            return prims
        short = (-len(prims)) % block
        return prims + [mk_pad() for _ in range(short)]

    spheres_p = padded(spheres, _pad_sphere)
    triangles_p = padded(triangles, _pad_triangle)

    scene2 = dataclasses.replace(
        scene,
        spheres=tuple(spheres_p),
        triangles=tuple(triangles_p),
    )

    groups: List[_Group] = []
    for i in range(0, len(spheres_p), block):
        members = spheres_p[i: i + block]
        real = [p for p in members if p.center[0] != _PAD_POS]
        groups.append(_Group(
            prims=tuple((scene_mod.SPHERE, p) for p in members),
            aabb=_block_aabb(scene_mod.SPHERE, real),
        ))
    if scene.planes:
        groups.append(_Group(
            prims=tuple((scene_mod.PLANE, p) for p in scene.planes),
            aabb=None,
        ))
    for i in range(0, len(triangles_p), block):
        members = triangles_p[i: i + block]
        real = [p for p in members if p.v0[0] != _PAD_POS]
        groups.append(_Group(
            prims=tuple((scene_mod.TRIANGLE, p) for p in members),
            aabb=_block_aabb(scene_mod.TRIANGLE, real),
        ))
    return scene2, groups


def _slab_any(o: V3, d: V3, t_min, closest, aabb, mask):
    """Scalar verdict: does ANY (masked) lane's ray segment
    [t_min, closest) intersect the block AABB? Branchless slab test with
    zero-direction components handled explicitly (axis parallel: inside
    slab = always, outside = never)."""
    (lx, ly, lz), (hx, hy, hz) = aabb
    tn = jnp.full_like(o.x, -_BIG)
    tf = jnp.full_like(o.x, _BIG)
    for oc, dc, lo, hi in ((o.x, d.x, lx, hx), (o.y, d.y, ly, hy),
                           (o.z, d.z, lz, hz)):
        par = dc == 0.0
        inv = 1.0 / jnp.where(par, 1.0, dc)
        t0 = (lo - oc) * inv
        t1 = (hi - oc) * inv
        a_min = jnp.minimum(t0, t1)
        a_max = jnp.maximum(t0, t1)
        inside = (oc >= lo) & (oc <= hi)
        a_min = jnp.where(par, jnp.where(inside, -_BIG, _BIG), a_min)
        a_max = jnp.where(par, jnp.where(inside, _BIG, -_BIG), a_max)
        tn = jnp.maximum(tn, a_min)
        tf = jnp.minimum(tf, a_max)
    hit = (tn <= tf) & (tn < closest) & (tf > t_min)
    if mask is not None:
        hit = hit & mask
    return jnp.any(hit)


class CulledPrims:
    """Drop-in ScenePrims replacement over the blocked order, swept
    densely (module docstring): identical results to a culled sweep, since
    culling is output-invariant."""

    def __init__(self, scene: scene_mod.Scene, block: int = BLOCK):
        self.scene_blocked, _groups = blocked_scene(scene, block)
        self.dense = geom.ScenePrims(self.scene_blocked)

    def closest_hit(self, o: V3, d: V3, t_min=geom.RAY_EPS,
                    t_max=geom.T_FAR, mask=None) -> geom.Hit:
        return self.dense.closest_hit(o, d, t_min, t_max)

    def occluded(self, o: V3, d: V3, t_min, t_max, mask=None):
        return self.dense.occluded(o, d, t_min, t_max)
