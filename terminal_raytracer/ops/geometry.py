"""Ray-primitive intersections and scene traversal, vectorized over lanes.

Intersection semantics are specified by the reference kernel
(reference: src/shader.wgsl:155-294) and replicated exactly, including the
epsilon constants and strict/non-strict bound checks that are visible in
output images:

* sphere — normalized-direction quadratic, root valid iff strictly inside
  (t_min, t_max); nearer root preferred (shader.wgsl:155-175). The
  reference's squared-distance early-reject (shader.wgsl:258-272) is a
  scalar-divergence optimization that never changes which rays hit (each of
  its three reject conditions implies the quadratic rejects too); in a
  vectorized kernel it saves nothing, so it is intentionally absent.
* plane — parallel iff |denom| < 1e-4; t valid iff t_min <= t <= t_max
  (non-strict, unlike sphere/triangle — shader.wgsl:178-189).
* triangle — Möller–Trumbore with parallel epsilon 1e-5 and strict
  t bounds (shader.wgsl:192-223).

Scene traversal is an *unrolled* closest-hit sweep over the static primitive
list in the reference's flatten order (spheres, planes, triangles —
src/lib.rs:120-154) with "strictly closer wins" (shader.wgsl:279), so tie
resolution matches. Primitive data are Python floats baked at trace time:
the compiler folds them into the instruction stream — zero geometry memory
traffic, in place of the reference's storage buffer. Shipped
scenes are <= ~30 primitives, so the unroll is small; larger scenes would
switch to the SoA array path (models/scene.py `to_arrays`).

Normals (shader.wgsl:234-245): spheres get (p - center)/radius normalized at
runtime; plane and triangle normals are compile-time f32 constants.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..models import scene as scene_mod
from . import vecmath as vm
from .vecmath import V3

# Epsilons, bit-matching the reference.
PLANE_PARALLEL_EPS = 1e-4  # shader.wgsl:180
TRI_PARALLEL_EPS = 1e-5  # shader.wgsl:198
RAY_EPS = 1e-3  # t_min / shadow offset / scatter offset (shader.wgsl:399,445,482)
T_FAR = 1e10  # shader.wgsl:445

MISS = -1.0


def _not(mask):
    """Logical not that also accepts Python bools.

    The intersection helpers run on jnp lane vectors AND on scalar Python
    floats (constant-folded baked geometry, tests/scalar_ref.py); `~` on a
    Python bool is deprecated (scheduled for removal in 3.16), while XOR
    with True is logical-not for both Python bools and boolean jnp masks
    (XLA folds xor(pred, true) to not — same program).
    """
    return mask ^ True


def intersect_sphere(o: V3, d: V3, center: V3, radius, t_min, t_max):
    """Returns hit distance, or -1.0 for a miss. shader.wgsl:155-175.

    Assumes |d| == 1 (the quadratic's `a` term is 1), as the reference does.
    """
    oc = center - o
    h = vm.dot(d, oc)
    c = vm.dot(oc, oc) - radius * radius
    disc = h * h - c
    sqrtd = jnp.sqrt(jnp.maximum(disc, 0.0))
    near = h - sqrtd
    far = h + sqrtd
    near_ok = (near > t_min) & (near < t_max)
    far_ok = (far > t_min) & (far < t_max)
    root = jnp.where(near_ok, near, far)
    hit = (disc >= 0.0) & (near_ok | far_ok)
    return jnp.where(hit, root, MISS)


def intersect_plane(o: V3, d: V3, point: V3, normal: V3, t_min, t_max):
    """shader.wgsl:178-189. Note the non-strict t bounds."""
    denom = vm.dot(normal, d)
    parallel = jnp.abs(denom) < PLANE_PARALLEL_EPS
    t = vm.dot(point - o, normal) / jnp.where(parallel, 1.0, denom)
    hit = _not(parallel) & (t >= t_min) & (t <= t_max)
    return jnp.where(hit, t, MISS)


def intersect_triangle(o: V3, d: V3, v0: V3, edge1: V3, edge2: V3, t_min, t_max):
    """Möller-Trumbore, shader.wgsl:192-223. Takes precomputed edges."""
    h = vm.cross(d, edge2)
    a = vm.dot(edge1, h)
    parallel = (a > -TRI_PARALLEL_EPS) & (a < TRI_PARALLEL_EPS)
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = vm.cross(s, edge1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(edge2, q)
    hit = (
        _not(parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )
    return jnp.where(hit, t, MISS)


# ---------------------------------------------------------------------------
# Boolean (any-hit) intersection forms — the shadow-ray sweep only consumes
# `(t > 0) & (t < t_max)` of the exact-t forms above, and with t_min > 0
# that boolean simplifies per primitive kind (bit-identical by case
# analysis; round-4 op cut — the two NEE shadow sweeps are ~34% of a
# scheduler iteration's ops at the north-star scene):
#
# * sphere — the returned root is the near root when in-bounds else the far
#   root, and `hit` already requires one of them strictly inside
#   (t_min, t_max); so blocked == hit.
# * plane — non-strict upper bound in the hit test, but the consumer's
#   `t < t_max` is strict: blocked == ~parallel & (t >= t_min) & (t < t_max).
# * triangle — strict bounds already: blocked == hit.
# ---------------------------------------------------------------------------


def blocked_sphere(o: V3, d: V3, center: V3, radius, t_min, t_max):
    oc = center - o
    h = vm.dot(d, oc)
    c = vm.dot(oc, oc) - radius * radius
    disc = h * h - c
    sqrtd = jnp.sqrt(jnp.maximum(disc, 0.0))
    near = h - sqrtd
    far = h + sqrtd
    near_ok = (near > t_min) & (near < t_max)
    far_ok = (far > t_min) & (far < t_max)
    return (disc >= 0.0) & (near_ok | far_ok)


def blocked_plane(o: V3, d: V3, point: V3, normal: V3, t_min, t_max):
    denom = vm.dot(normal, d)
    parallel = jnp.abs(denom) < PLANE_PARALLEL_EPS
    t = vm.dot(point - o, normal) / jnp.where(parallel, 1.0, denom)
    return _not(parallel) & (t >= t_min) & (t < t_max)


def blocked_triangle(o: V3, d: V3, v0: V3, edge1: V3, edge2: V3, t_min,
                     t_max):
    h = vm.cross(d, edge2)
    a = vm.dot(edge1, h)
    parallel = (a > -TRI_PARALLEL_EPS) & (a < TRI_PARALLEL_EPS)
    f = 1.0 / jnp.where(parallel, 1.0, a)
    s = o - v0
    u = f * vm.dot(s, h)
    q = vm.cross(s, edge1)
    v = f * vm.dot(d, q)
    t = f * vm.dot(edge2, q)
    return (
        _not(parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > t_min)
        & (t < t_max)
    )


# ---------------------------------------------------------------------------
# Fused two-ray any-hit forms ("amortize each primitive's operand load
# across multiple ray payloads"). The two NEE
# shadow rays of one bounce share their ORIGIN (p + normal*eps for both
# lights), so every origin-only subexpression of the blocked_* forms above
# — sphere's oc and |oc|^2 - r^2, plane's dot(point - o, normal), the
# triangle's s = o - v0 and q = cross(s, edge1) — can be computed once for
# both payloads. Each per-ray result is the EXACT blocked_* expression
# (same ops, same order), so fused results are bit-identical; whether the
# sharing buys wall time on the H100 is not measured (ROADMAP D3). Opt-in
# via PathTracer(fuse_nee=True).
# ---------------------------------------------------------------------------


def blocked_sphere2(o: V3, d1: V3, t_max1, d2: V3, t_max2, center, radius,
                    t_min):
    oc = center - o
    c = vm.dot(oc, oc) - radius * radius

    def one(d, t_max):
        h = vm.dot(d, oc)
        disc = h * h - c
        sqrtd = jnp.sqrt(jnp.maximum(disc, 0.0))
        near = h - sqrtd
        far = h + sqrtd
        near_ok = (near > t_min) & (near < t_max)
        far_ok = (far > t_min) & (far < t_max)
        return (disc >= 0.0) & (near_ok | far_ok)

    return one(d1, t_max1), one(d2, t_max2)


def blocked_plane2(o: V3, d1: V3, t_max1, d2: V3, t_max2, point, normal,
                   t_min):
    num = vm.dot(point - o, normal)

    def one(d, t_max):
        denom = vm.dot(normal, d)
        parallel = jnp.abs(denom) < PLANE_PARALLEL_EPS
        t = num / jnp.where(parallel, 1.0, denom)
        return _not(parallel) & (t >= t_min) & (t < t_max)

    return one(d1, t_max1), one(d2, t_max2)


def blocked_triangle2(o: V3, d1: V3, t_max1, d2: V3, t_max2, v0, edge1,
                      edge2, t_min):
    s = o - v0
    q = vm.cross(s, edge1)

    def one(d, t_max):
        h = vm.cross(d, edge2)
        a = vm.dot(edge1, h)
        parallel = (a > -TRI_PARALLEL_EPS) & (a < TRI_PARALLEL_EPS)
        f = 1.0 / jnp.where(parallel, 1.0, a)
        u = f * vm.dot(s, h)
        v = f * vm.dot(d, q)
        t = f * vm.dot(edge2, q)
        return (
            _not(parallel)
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (t > t_min)
            & (t < t_max)
        )

    return one(d1, t_max1), one(d2, t_max2)


class Hit(NamedTuple):
    """Per-lane closest-hit record (shader.wgsl:39-47). `found` replaces the
    reference's `t < 0` sentinel check; `normal` is already front-face
    flipped (shader.wgsl:284-287).

    `light_inv_area`: 1/area of the hit primitive iff it is an NEE-sampled
    light (emissive sphere/triangle — the set shader.wgsl:390-391 samples),
    else 0. Only the MIS transport mode (ops/tracer.py) consumes it — the
    balance-heuristic weight of a BSDF path hitting a light needs the area
    pdf NEE would have used; XLA dead-code-eliminates it elsewhere.

    `transparency` / `ior` / `front`: the dielectric extension channels
    (models/scene.py Material). `front` is the pre-flip front-face mask
    (already computed for the normal flip — free); `ior` is only
    meaningful on lanes where `transparency > 0` (the baked sweep zeros
    it elsewhere to keep its grouped constant-select free; the tracer
    re-selects a safe value before dividing). Consumed only when the
    scene has dielectrics — the tracer's glass branch is statically gated,
    so reference scenes compile to the exact pre-extension program."""

    found: jnp.ndarray  # bool lanes
    t: jnp.ndarray
    p: V3
    normal: V3
    color: V3
    emission: V3
    reflectivity: jnp.ndarray
    light_inv_area: jnp.ndarray = None
    transparency: jnp.ndarray = None
    ior: jnp.ndarray = None
    front: jnp.ndarray = None
    # Metal roughness (extension): fuzz radius of the hit's mirror branch,
    # same zero-cost-when-absent contract as transparency/ior.
    roughness: jnp.ndarray = None
    # Procedural checker texture (extension): alternate color + cell scale
    # (scale 0 = untextured lane); same zero-cost contract.
    checker_color: V3 = None
    checker_scale: jnp.ndarray = None
    # Image texture (extension): SIGNED atlas id (+planar / -spherical
    # mapping, 0 = untextured lane) + uv tiling scale; same zero-cost
    # contract (models/scene.py texture_channel, ops/tracer.py
    # _texture_recolor).
    tex_index: jnp.ndarray = None
    tex_scale: jnp.ndarray = None
    # Normal map (extension): SIGNED atlas id (+planar / -spherical, 0 =
    # unmapped lane) + uv tiling scale + tangential strength; same
    # zero-cost contract (models/scene.py normal_channel, ops/tracer.py
    # _apply_normal_map).
    nm_index: jnp.ndarray = None
    nm_scale: jnp.ndarray = None
    nm_strength: jnp.ndarray = None


def _c3(v) -> V3:
    """A compile-time constant 3-vector from Python floats."""
    return V3(float(v[0]), float(v[1]), float(v[2]))


def _tri_edges_f32(tri: scene_mod.Triangle):
    """Precompute triangle edges / geometric normal / area in f32, matching
    the shader's runtime f32 arithmetic (shader.wgsl:193-194, 386-389)."""
    v0 = np.asarray(tri.v0, np.float32)
    e1 = np.asarray(tri.v1, np.float32) - v0
    e2 = np.asarray(tri.v2, np.float32) - v0
    cr = np.cross(e1, e2).astype(np.float32)
    cr_len = np.float32(np.sqrt(np.float32(np.dot(cr, cr))))
    # Degenerate (zero-area) triangles get a NaN normal, exactly like the
    # reference's runtime f32 divide would (shader.wgsl:194) — silence
    # only the host-side numpy warning, not the value.
    with np.errstate(invalid="ignore", divide="ignore"):
        normal = (cr / cr_len).astype(np.float32)
    area = np.float32(0.5) * cr_len
    return e1, e2, normal, float(area)


class ScenePrims:
    """Compiled-constant traversal functions for one static scene (or an
    explicit (tag, primitive) list — the block-culled accelerator sweeps
    per-block sublists, ops/accel.py)."""

    def __init__(self, scene, tex_channel=None, nm_channel=None):
        """`tex_channel` / `nm_channel`: (tag, material) -> channel values
        resolving image-texture / normal-map names against the OWNING
        scene's registry (Scene.texture_channel / normal_channel) —
        required only for explicit-list construction whose materials use
        them (the block-culled accelerator passes its source scene's; a
        Scene argument supplies its own)."""
        if isinstance(scene, scene_mod.Scene):
            self.scene = scene
            prim_list = scene.primitives
            tex_channel = scene.texture_channel
            nm_channel = scene.normal_channel
        else:
            self.scene = None
            prim_list = tuple(scene)
        if tex_channel is None:
            def tex_channel(tag, m):
                if m.is_textured:  # pragma: no cover - misuse guard
                    raise ValueError(
                        "textured material in an explicit primitive list "
                        "needs tex_channel= (the owning scene's "
                        "texture_channel)"
                    )
                return (0.0, 0.0)
        if nm_channel is None:
            def nm_channel(tag, m):
                if m.is_normal_mapped:  # pragma: no cover - misuse guard
                    raise ValueError(
                        "normal-mapped material in an explicit primitive "
                        "list needs nm_channel= (the owning scene's "
                        "normal_channel)"
                    )
                return (0.0, 0.0, 0.0)
        # Per primitive, in reference flatten order:
        #   (intersect(o, d, t_min, t_max) -> t, normal(p) -> V3, material)
        self._prims: List[Tuple[Callable, Callable, scene_mod.Material]] = []
        # Boolean any-hit forms (blocked_*), one per primitive — the
        # shadow-ray sweep's op-lean path. _blocked2 holds the fused
        # two-ray forms (blocked_*2, shared-origin subexpressions hoisted)
        # consumed by occluded2 — the fuse_nee probe path.
        self._blocked: List[Callable] = []
        self._blocked2: List[Callable] = []
        # Per primitive: the compile-time unit normal (plane/triangle), or
        # None for spheres whose normal is runtime math. Used by the
        # grouped-select sweep below.
        self._const_normal: List = []
        self._sphere_geom: List = []  # (center V3, inv_r) or None
        # Per primitive: 1/area if it is an NEE-sampled light (emissive
        # sphere/triangle, shader.wgsl:390-391 skips planes), else 0 — the
        # Hit.light_inv_area channel (MIS mode).
        self._light_inv_area: List[float] = []
        # Per primitive: (signed texture id, uv scale) — the image-texture
        # channels (0, 0) = untextured (models/scene.py texture_channel).
        self._tex: List[Tuple[float, float]] = []
        # Per primitive: (signed id, uv scale, strength) — the normal-map
        # channels, (0, 0, 0) = unmapped (models/scene.py normal_channel).
        self._nm: List[Tuple[float, float, float]] = []
        for tag, prim in prim_list:
            self._tex.append(tex_channel(tag, prim.material))
            self._nm.append(nm_channel(tag, prim.material))
            # NEE samples a primitive iff sum(emission) > 1e-3 — the
            # reference's light_power test (shader.wgsl:345-346), which
            # Material.is_light mirrors. light_inv_area must gate on the
            # same set: it is the pdf of the NEE strategy MIS weighs
            # against, so a sub-threshold emitter (never NEE-sampled)
            # keeps lia = 0 and its BSDF hits keep full weight.
            emissive = prim.material.is_light
            if emissive and tag == scene_mod.SPHERE:
                area = 4.0 * 3.14159265359 * float(prim.radius) ** 2
                self._light_inv_area.append(1.0 / area)
            elif emissive and tag == scene_mod.TRIANGLE:
                self._light_inv_area.append(1.0 / _tri_edges_f32(prim)[3])
            else:
                self._light_inv_area.append(0.0)
            if tag == scene_mod.SPHERE:
                c, r = _c3(prim.center), float(prim.radius)
                inv_r = float(np.float32(1.0) / np.float32(prim.radius))

                def isect(o, d, t_min, t_max, c=c, r=r):
                    return intersect_sphere(o, d, c, r, t_min, t_max)

                def blk(o, d, t_min, t_max, c=c, r=r):
                    return blocked_sphere(o, d, c, r, t_min, t_max)

                def blk2(o, d1, tm1, d2, tm2, t_min, c=c, r=r):
                    return blocked_sphere2(o, d1, tm1, d2, tm2, c, r, t_min)

                def norm(p, c=c, inv_r=inv_r):
                    # (p - center)/radius, then normalize (shader.wgsl:236)
                    return vm.normalize((p - c) * inv_r)

                self._const_normal.append(None)
                self._sphere_geom.append((c, inv_r))

            elif tag == scene_mod.PLANE:
                pt, n = _c3(prim.point), np.asarray(prim.normal, np.float32)
                n_unit = _c3(n / np.sqrt(np.dot(n, n)))
                n_raw = _c3(prim.normal)

                def isect(o, d, t_min, t_max, pt=pt, n_raw=n_raw):
                    return intersect_plane(o, d, pt, n_raw, t_min, t_max)

                def blk(o, d, t_min, t_max, pt=pt, n_raw=n_raw):
                    return blocked_plane(o, d, pt, n_raw, t_min, t_max)

                def blk2(o, d1, tm1, d2, tm2, t_min, pt=pt, n_raw=n_raw):
                    return blocked_plane2(o, d1, tm1, d2, tm2, pt, n_raw,
                                          t_min)

                def norm(p, n_unit=n_unit):
                    return n_unit

                self._const_normal.append((n_unit.x, n_unit.y, n_unit.z))
                self._sphere_geom.append(None)

            else:  # TRIANGLE
                e1, e2, n, _ = _tri_edges_f32(prim)
                v0, e1c, e2c, n_unit = _c3(prim.v0), _c3(e1), _c3(e2), _c3(n)

                def isect(o, d, t_min, t_max, v0=v0, e1c=e1c, e2c=e2c):
                    return intersect_triangle(o, d, v0, e1c, e2c, t_min, t_max)

                def blk(o, d, t_min, t_max, v0=v0, e1c=e1c, e2c=e2c):
                    return blocked_triangle(o, d, v0, e1c, e2c, t_min, t_max)

                def blk2(o, d1, tm1, d2, tm2, t_min, v0=v0, e1c=e1c,
                         e2c=e2c):
                    return blocked_triangle2(o, d1, tm1, d2, tm2, v0, e1c,
                                             e2c, t_min)

                def norm(p, n_unit=n_unit):
                    return n_unit

                self._const_normal.append((n_unit.x, n_unit.y, n_unit.z))
                self._sphere_geom.append(None)

            self._prims.append((isect, norm, prim.material))
            self._blocked.append(blk)
            self._blocked2.append(blk2)

    def raw_closest(self, o: V3, d: V3, t_min, t_max):
        """Closest-hit sweep WITHOUT the front-face flip: returns
        (t, found, p, normal_raw, col, emi, refl, light_inv_area, transp,
        ior, rough, checker_color, checker_scale) with t == t_max where
        nothing hit (the extension channels are zero/broadcast constants
        on scenes that lack them — see Hit). Sweeping a sublist continues an outer chain exactly
        when called with the outer running closest as t_max (the culled
        accelerator does this per block, ops/accel.py).

        Op-lean formulation: the sweep tracks only the running `closest` and
        a WINNER INDEX (the overwrite chain means the last strictly-closer
        primitive in sweep order won, shader.wgsl:279 — one select per
        primitive records it); materials and normals resolve *after* the
        sweep via lazily-built one-hot masks (idx == k, cached across
        channels) with constants grouped by value — one select per distinct
        channel value instead of eleven selects per primitive, and `found`
        is a single closest < t_max compare. Bit-identical to the naive
        overwrite chain (the winner's t equals `closest`, so its hit
        point / normal math sees the same inputs; the one-hot masks are
        boolean-identical to the reversed better&~taken scan; selected
        constants are the same constants)."""
        lanes = o.x
        zeros = jnp.zeros_like(lanes)
        closest = zeros + t_max
        idx = zeros - 1.0  # winner index, -1 = miss
        for k, (isect, _, _) in enumerate(self._prims):
            t = isect(o, d, t_min, closest)
            better = (t > 0.0) & (t < closest)  # shader.wgsl:279
            closest = jnp.where(better, t, closest)
            idx = jnp.where(better, jnp.float32(k), idx)
        # Any better strictly lowered `closest` below the initial t_max.
        found = closest < t_max

        n_prims = len(self._prims)
        onehot_cache = {}

        def winner(k):
            m = onehot_cache.get(k)
            if m is None:
                m = onehot_cache[k] = idx == jnp.float32(k)
            return m

        mask_cache = {}

        def group_mask(ks):
            key = frozenset(ks)
            m = mask_cache.get(key)
            if m is None:
                m = winner(ks[0])
                for k in ks[1:]:
                    m = m | winner(k)
                mask_cache[key] = m
            return m

        def grouped(values):
            """Select among compile-time channel values: one masked select
            per distinct nonzero value (winner masks are disjoint, so adds
            compose exactly); masks shared across channels with the same
            primitive grouping."""
            groups = {}
            for k, v in enumerate(values):
                groups.setdefault(float(v), []).append(k)
            out = zeros
            for v, ks in groups.items():
                if v == 0.0:
                    continue
                out = out + jnp.where(group_mask(ks), jnp.float32(v), 0.0)
            return out

        mats = [m for _, _, m in self._prims]
        col = V3(
            grouped([m.color[0] for m in mats]),
            grouped([m.color[1] for m in mats]),
            grouped([m.color[2] for m in mats]),
        )
        emi = V3(
            grouped([m.emission[0] for m in mats]),
            grouped([m.emission[1] for m in mats]),
            grouped([m.emission[2] for m in mats]),
        )
        refl = grouped([m.reflectivity for m in mats])
        light_inv_area = grouped(self._light_inv_area)
        # Dielectric channels: all-zero (i.e. a free broadcast constant)
        # for reference scenes. ior is zeroed on non-dielectric materials
        # so IT stays free too — the tracer only reads it where
        # transparency > 0 (Hit docstring).
        transp = grouped([m.transparency for m in mats])
        ior = grouped([m.ior if m.transparency > 0.0 else 0.0
                       for m in mats])
        rough = grouped([m.roughness for m in mats])
        ck = [m.checker_color or (0.0, 0.0, 0.0) for m in mats]
        checker_color = V3(grouped([c[0] for c in ck]),
                           grouped([c[1] for c in ck]),
                           grouped([c[2] for c in ck]))
        checker_scale = grouped([m.checker_scale if m.is_checker else 0.0
                                 for m in mats])
        # Image-texture channels: all-zero (free broadcast constants) for
        # untextured scenes, like transp.
        tex_index = grouped([t[0] for t in self._tex])
        tex_scale = grouped([t[1] for t in self._tex])
        # Normal-map channels: all-zero (free broadcast constants) for
        # unmapped scenes, like tex_index.
        nm_index = grouped([c[0] for c in self._nm])
        nm_scale = grouped([c[1] for c in self._nm])
        nm_strength = grouped([c[2] for c in self._nm])

        p = o + d * closest

        # Normals: constant normals (planes/triangles) group by value like
        # materials; sphere normals need runtime math for their own winners.
        const_ks = [k for k in range(n_prims) if self._const_normal[k] is not None]
        normal = V3(
            grouped([
                self._const_normal[k][0] if self._const_normal[k] else 0.0
                for k in range(n_prims)
            ]),
            grouped([
                self._const_normal[k][1] if self._const_normal[k] else 0.0
                for k in range(n_prims)
            ]),
            grouped([
                self._const_normal[k][2] if self._const_normal[k] else 0.0
                for k in range(n_prims)
            ]),
        ) if const_ks else vm.splat(zeros)
        for k, geom in enumerate(self._sphere_geom):
            if geom is None:
                continue
            c, inv_r = geom
            n_k = vm.normalize((p - c) * inv_r)
            normal = vm.where(winner(k), n_k, normal)

        return (closest, found, p, normal, col, emi, refl, light_inv_area,
                transp, ior, rough, checker_color, checker_scale,
                tex_index, tex_scale, nm_index, nm_scale, nm_strength)

    def closest_hit(self, o: V3, d: V3, t_min=RAY_EPS, t_max=T_FAR,
                    mask=None) -> Hit:
        """Brute-force linear closest-hit sweep (shader.wgsl:248-294).
        `mask` (live lanes) is accepted for interface parity with the
        block-culled accelerator (ops/accel.py) and ignored here — every
        lane sweeps everything, as the reference does."""
        del mask
        (closest, found, p, normal, col, emi, refl, lia, transp, ior,
         rough, ck_col, ck_scale, tex_idx, tex_scl, nm_idx, nm_scl,
         nm_str) = self.raw_closest(o, d, t_min, t_max)
        # Front-face flip (shader.wgsl:284-287).
        front = vm.dot(d, normal) < 0.0
        normal = vm.where(front, normal, -normal)
        # NEE only lights the front face of a light (its cos_l clamp,
        # shader.wgsl:409): a back-face hit (e.g. from inside an emissive
        # sphere) is unreachable by NEE, so its competing pdf is 0 and the
        # BSDF hit keeps full MIS weight.
        lia = jnp.where(front, lia, 0.0)
        return Hit(found, closest, p, normal, col, emi, refl, lia,
                   transparency=transp, ior=ior, front=front,
                   roughness=rough, checker_color=ck_col,
                   checker_scale=ck_scale, tex_index=tex_idx,
                   tex_scale=tex_scl, nm_index=nm_idx, nm_scale=nm_scl,
                   nm_strength=nm_str)

    def occluded(self, o: V3, d: V3, t_min, t_max, mask=None) -> jnp.ndarray:
        """Any-hit visibility test for shadow rays (shader.wgsl:399-402:
        a full hit_scene whose only consumed output is `hit.t < 0`).
        `mask` ignored here (see closest_hit). Uses the boolean blocked_*
        forms — bit-identical to `(isect(...) > 0) & (isect(...) < t_max)`
        (case analysis at their definitions), minus the per-primitive root
        selection and re-checks."""
        del mask
        blocked = jnp.zeros_like(o.x, dtype=bool)
        for blk in self._blocked:
            blocked = blocked | blk(o, d, t_min, t_max)
        return blocked

    def occluded2(self, o: V3, d1: V3, t_max1, d2: V3, t_max2,
                  t_min=RAY_EPS, mask=None):
        """Fused any-hit test for TWO shadow rays sharing one origin (the
        two NEE lights of a bounce) — each primitive's origin-dependent
        subexpressions are computed once for both payloads (blocked_*2).
        Per-ray results are bit-identical to two occluded() calls: same
        expressions, same sweep/OR order. The fuse_nee path."""
        del mask
        b1 = jnp.zeros_like(o.x, dtype=bool)
        b2 = jnp.zeros_like(o.x, dtype=bool)
        for blk2 in self._blocked2:
            r1, r2 = blk2(o, d1, t_max1, d2, t_max2, t_min)
            b1 = b1 | r1
            b2 = b2 | r2
        return b1, b2
