"""The wavefront path-tracing core.

This module re-designs the reference's WGSL megakernel (reference:
src/shader.wgsl:439-622) as shape-polymorphic pure ``jax.numpy`` over a
*lane grid*: the same code renders

* a whole image at once under ``jax.jit`` — the XLA **oracle** renderer
  (CPU or GPU) and correctness reference for everything else, and
* one power-of-two block of pixels inside the **GPU megakernel**
  (ops/pallas_kernel.py), which only adds memory orchestration.

Divergence model ("no per-lane break on SIMD", SURVEY.md §7): the
reference's per-thread ``break`` statements (miss, Russian roulette) become
per-lane *mask bits*; all lanes advance one bounce per step of a
``lax.while_loop`` that exits early once every lane in the grid is dead.
Data-dependent RNG draw order therefore becomes fixed draw order — which is
why parity with the reference is "modulo RNG" (PARITY.md).

Faithfully replicated reference behaviors (SURVEY.md §7 fidelity list):

* emission added on every hit *plus* NEE every bounce with no MIS — the
  reference's brighter-than-physical direct light (shader.wgsl:455-459);
* NEE per-channel clamp at 10.0 (shader.wgsl:420-427); plane lights never
  sampled (shader.wgsl:390-391);
* sky = 0.8 * lerp(white, (.5,.7,1)) on miss (shader.wgsl:297-304);
* epsilon 0.001 for t_min / shadow rays / ray offset (shader.wgsl:399,445,482);
* Russian roulette from bounce 4, survival min(0.95, max(att)), kill before
  compensation (shader.wgsl:485-492);
* adaptive sampling: base = max(4, spp/4) samples, luminance-sum variance,
  extra = min(spp-base, trunc(var*50)) iff var > 10 (shader.wgsl:513-562)
  — including the normalization quirks: non-adaptive pixels divide a
  base-sample sum by full spp, and spp < 4 *brightens* by base/spp
  (shader.wgsl:600-610).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import scene as scene_mod
from . import geometry as geom
from . import rng as prng
from . import sampling
from . import vecmath as vm
from .vecmath import V3

_STRAT_FALLBACK_NOTED: set = set()


def _note_stratified_fallback(reason: str) -> None:
    """One-line stderr note when an explicit `sampler: stratified` resolves
    to strat_g == 1 (a silent fallback would be undiagnosable).
    Deduplicated per reason — a render builds many PathTracers (oracle +
    kernels + shards) and the note is about the run, not the object."""
    if reason not in _STRAT_FALLBACK_NOTED:
        _STRAT_FALLBACK_NOTED.add(reason)
        import sys

        print("note: sampler=stratified inactive: " + reason,
              file=sys.stderr)


# Constants from the reference kernel.
SKY_INTENSITY = 0.8  # shader.wgsl:303
SKY_TOP = (0.5, 0.7, 1.0)  # shader.wgsl:301
NEE_CLAMP = 10.0  # shader.wgsl:420
# Rec.709 luma weights — the 'power' light-sampling mode's luminance
# (the same weights ops/tonemap.py ranks glyph brightness by).
_LUM = (0.2126, 0.7152, 0.0722)
RR_START_BOUNCE = 3  # "i > 3u", shader.wgsl:485
RR_MAX_SURVIVAL = 0.95  # shader.wgsl:486
ADAPTIVE_VAR_THRESHOLD = 10.0  # shader.wgsl:561
ADAPTIVE_VAR_SCALE = 50.0  # shader.wgsl:562
# Default for PathTracer(fuse_nee=None): fuse the two NEE shadow sweeps
# into one shared-origin pass (geometry.occluded2). Bit-identical output
# either way — see direct_light. OFF: it lost on the earlier accelerator
# (deferring the occlusion tests lengthens the live ranges of both
# lights' contrib/ok planes); not measured on the H100 (ROADMAP D3).
FUSE_NEE = False


def gather_texels(tab, idx, n_rows, lo=0, direct=False):
    """Per-lane fetch ``tab.flat[idx]`` from the packed (rows, 128) i32
    texel atlas (models/texture.py), restricted to atlas rows [lo, n_rows):
    indices outside that range (untextured lanes) return 0. The bounds are
    static -- callers whose indices provably land in a sub-range (a single
    known texture, e.g. the sky map) pass only that slice.

    ``direct=False`` (the XLA path) sweeps the rows: for each atlas row,
    lane-gather the in-row column ``idx & 127`` and select the rows'
    results by ``idx >> 7`` -- O(n_rows - lo) vector ops.
    ``direct=True`` (the GPU kernel, where ``tab`` is a global-memory ref)
    is one indexed load per lane."""
    return gather_texels_multi(tab, (idx,), n_rows, lo, direct)[0]


def gather_texels_multi(tab, idxs, n_rows, lo=0, direct=False):
    """gather_texels for SEVERAL per-lane index grids at once; the row
    sweep shares each atlas row's broadcast across the fetches (the
    bilinear filter's 2x2 fetch)."""
    rs = [jax.lax.shift_right_logical(i, 7) for i in idxs]
    cs = [jnp.bitwise_and(i, 127) for i in idxs]
    if direct:
        if n_rows <= lo:
            return [jnp.zeros(c.shape, jnp.int32) for c in cs]
        return [jnp.where((r >= lo) & (r < n_rows),
                          tab[jnp.clip(r, lo, n_rows - 1), c], 0)
                for r, c in zip(rs, cs)]
    c0 = cs[0]
    lead = (1,) * (c0.ndim - 1)
    shape = c0.shape[:-1] + (128,)
    # dtype-polymorphic: the first row's gather fixes the output dtype
    # (i32 texel atlas, f32 gathered-traversal tables -- ops/gathered.py).
    outs = [None] * len(idxs)
    for k in range(lo, n_rows):
        row = jnp.broadcast_to(
            jnp.reshape(tab[k:k + 1, :], lead + (128,)), shape)
        for j, (r, c) in enumerate(zip(rs, cs)):
            got = jnp.take_along_axis(row, c, axis=-1)
            outs[j] = jnp.where(r == k, got,
                                jnp.zeros_like(got) if outs[j] is None
                                else outs[j])
    return [jnp.zeros(c0.shape, jnp.int32) if o is None else o
            for o in outs]


class Cam(NamedTuple):
    """Per-frame camera basis as traced scalars (the only per-frame-varying
    render inputs besides seed/frame — SURVEY.md §3.5)."""

    pos: V3
    forward: V3
    right: V3
    up: V3


def cam_from_pose(pose) -> Cam:
    """Unpack a models.camera.Camera.pose() (16,) f32 array (or any
    indexable of scalars — e.g. a kernel's input ref)."""
    return Cam(
        pos=V3(pose[0], pose[1], pose[2]),
        forward=V3(pose[3], pose[4], pose[5]),
        right=V3(pose[6], pose[7], pose[8]),
        up=V3(pose[9], pose[10], pose[11]),
    )


def sky_color(d: V3) -> V3:
    """shader.wgsl:297-304."""
    t = 0.5 * (d.y + 1.0)
    one = 1.0 - t
    return V3(
        (one + t * SKY_TOP[0]) * SKY_INTENSITY,
        (one + t * SKY_TOP[1]) * SKY_INTENSITY,
        (one + t * SKY_TOP[2]) * SKY_INTENSITY,
    )


def base_sample_count(spp: int) -> int:
    """base = max(4, spp/4), shader.wgsl:513."""
    return max(4, spp // 4)


# ---------------------------------------------------------------------------
# Dielectric (glass) scatter math — capability extension. The reference has
# no refractive materials (its BSDF is stochastic mirror-or-Lambert only,
# shader.wgsl:465-480); scenes without dielectrics compile to the exact
# reference program (the glass branch is statically gated in bounce_step).
# Pure shape-polymorphic lane math, shared by the jnp oracle and the Pallas
# kernels like the rest of this module.
# ---------------------------------------------------------------------------


def fresnel_schlick(cos_i, eta):
    """Schlick's approximation of the unpolarized Fresnel reflectance:
    r0 + (1 - r0)(1 - cos_i)^5, r0 = ((1 - eta)/(1 + eta))^2 — the
    normal-incidence reflectance (identical for eta and 1/eta)."""
    r = (1.0 - eta) / (1.0 + eta)
    r0 = r * r
    m = 1.0 - cos_i
    m2 = m * m
    return r0 + (1.0 - r0) * (m2 * m2 * m)


def refract(d: V3, n: V3, eta):
    """Refract the unit direction `d` about the unit FRONT-FACE normal `n`
    (dot(d, n) <= 0) with relative index eta = n_incident / n_transmitted.
    Returns (t_dir V3, cos_i, cos_t, tir): the Snell-exact transmitted
    direction (unit up to f32 rounding), the incident and transmitted
    cosines, and the total-internal-reflection mask (t_dir/cos_t are
    meaningless where tir)."""
    cos_i = jnp.minimum(-vm.dot(d, n), 1.0)
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    t_dir = d * eta + n * (eta * cos_i - cos_t)
    return t_dir, cos_i, cos_t, tir


# accel='auto' switches from the unrolled baked sweep to the array-resident
# fori_loop sweep (ops/arrayscene.py) above this primitive count. The baked
# sweep's unrolled code grows O(N); the array sweep is O(1) code over SoA
# data. Not measured on the H100 (ROADMAP S6).
ARRAY_AUTO_THRESHOLD = 96

# Heavy-pixel chunk-split. At array scales the occupancy tail is single
# heavy pixels (NOTES.md "measured dead ends"): no lane assignment can split one pixel's
# sequential sample chain, so the chain itself is split — a pixel's base
# quota becomes ceil(base/chunk_base) independent stream entries of
# <= chunk_base samples (and the adaptive extra budget likewise in
# <= chunk_extra slices). Chunk c > 0 re-seeds a decorrelated sub-chain at
# state + c * CHUNK_GOLDEN with ABSOLUTE sample indices (the per-sample
# re-hash keeps its shader.wgsl:517 structure); chunk 0 is bit-identical
# to the head of the sequential chain, and the extra phase continues from
# chunk 0's end state. The SAME derivation runs in the jnp oracle
# (render_lanes) and the kernel body (render_lanes_regen), so the
# pallas-vs-jnp estimator equality holds on the chunked estimator; parity
# with the reference stays "modulo RNG" (PARITY.md),
# which is why shipped-scale scenes (baked traversal) keep chunking OFF —
# their per-lane chains remain bit-identical to the reference's threads.
CHUNK_GOLDEN = 0x9E3779B9
# 'auto' chunk sizes at array scales, and the primitive count above which
# 'auto' chunking fires. Not measured on the H100 (ROADMAP S6).
ARRAY_CHUNK_BASE = 2
ARRAY_CHUNK_EXTRA = 2
CHUNK_AUTO_THRESHOLD = 512


class _Light(NamedTuple):
    kind: int  # scene_mod.SPHERE or TRIANGLE
    # sphere: center / radius; triangle: v0, v1, v2 + precomputed normal/area
    data: tuple
    emission: Tuple[float, float, float]


class PathTracer:
    """A path tracer compiled for one static scene.

    Scene geometry/materials are Python-float constants baked into the traced
    computation (see models/scene.py); spp / max_depth / resolution are
    static too, mirroring the reference where they live in per-frame uniforms
    but never actually change (src/lib.rs:418-430).
    """

    def __init__(self, scene: scene_mod.Scene,
                 unbiased: bool = False, base_quota: Optional[int] = None,
                 accel: str = "auto", transport: Optional[str] = None,
                 dynamic: bool = False, dyn_animated=None,
                 chunk_base="auto", chunk_extra="auto",
                 fuse_nee: Optional[bool] = None):
        """transport selects the light-transport estimator; all three trace
        the exact same paths (identical RNG chains — none of them draws
        anything new), differing only in how hit emission and NEE
        contributions are weighted:

        * 'reference' (default) reproduces the reference exactly —
          including its double counting of direct light: emission is added
          on every hit *and* lights are NEE-sampled every bounce with no
          MIS (shader.wgsl:455,458).
        * 'unbiased' adds hit emission only when the path could not have
          NEE-sampled it — at the camera hit, after a delta (mirror or
          glass) scatter, or when the emitter itself is outside NEE's
          reach (plane lights, back faces, sub-threshold emitters — the
          hit.light_inv_area == 0 set) — removing the double count (the
          `--unbiased` capability extension of SURVEY.md §7).
        * 'mis' weighs BOTH estimators by the balance heuristic (Veach):
          hit emission after a diffuse scatter gets
          p_bsdf / (p_bsdf + p_nee), each NEE light sample gets
          p_nee / (p_nee + p_bsdf), with p_bsdf the solid-angle pdf of the
          stochastic mirror-or-cosine scatter's continuous part,
          (1 - reflectivity) * cos/pi, and p_nee the light's area pdf
          converted to solid angle, t^2 / (cos_l * area). Mirror chains are
          delta-distributed: their hits keep full emission weight (a FUZZY
          mirror, roughness > 0, is instead a continuous lobe with an
          analytic pdf — NEE estimates it and the balance weights use the
          full mixture density, see direct_light's `rough`). NEE
          additionally carries the (1 - reflectivity) mixture factor (see
          direct_light), making both strategies estimate the physical
          BSDF mixture — so on partially-reflective surfaces 'mis' and
          'unbiased' legitimately differ in expectation ('unbiased' keeps
          the reference's full-Lambert NEE regardless of reflectivity);
          on diffuse surfaces their means agree, with 'mis' at lower
          variance wherever one strategy is poor (small bright lights ->
          NEE wins; large/near lights -> BSDF wins). Fog scenes are
          supported: volume scatter events compete NEE against the
          Henyey-Greenstein phase pdf, and in a medium the BSDF/phase
          strategy's density for reaching an emitter carries the
          no-collision probability exp(-sigma t) (its distance draw must
          overshoot the light), mirrored on both weight sites.

        `unbiased=True` is the legacy spelling of transport='unbiased'.

        base_quota (optional): the number of base-phase samples this tracer
        actually renders per pixel, when it differs from the reference's
        max(4, spp/4) — the sample-split multi-chip path renders each
        shard's share of the global base budget (parallel/mesh.py). NOTE:
        self.base_samples feeds variance_of / extra_quota / combine_phases
        too; a caller overriding it must normalize with the *global* base
        count externally (mesh.py does)."""
        # Opt-in: fuse the two NEE shadow sweeps of a bounce into one
        # shared-origin pass (geometry.occluded2 via direct_light's
        # deferred accumulation). Bit-identical output; only the op
        # schedule changes. None inherits the module default FUSE_NEE.
        self.fuse_nee = FUSE_NEE if fuse_nee is None else bool(fuse_nee)
        if transport is None:
            transport = "unbiased" if unbiased else "reference"
        assert transport in ("reference", "unbiased", "mis")
        self.transport = transport
        self.unbiased = transport == "unbiased"
        # The emit-info carry value of a fresh camera ray: 'mis' carries the
        # previous scatter's pdf there, with -1 marking a delta history
        # (camera / mirror chain, emission at full weight); the other modes
        # carry a may-emit flag, true for a fresh ray.
        self._emit_fresh = -1.0 if transport == "mis" else 1.0
        self.scene = scene
        # Static gate for the dielectric scatter branch (and its one extra
        # gated RNG draw): False compiles the exact reference program.
        # Template-scene property — in dynamic mode, VALUES animate but a
        # material can't gain a glass branch at runtime (same contract as
        # the static light topology, ops/dynamic.py).
        self.has_glass = scene.has_dielectrics
        # Same static-gate contract for the metal-roughness (fuzzy mirror)
        # branch. Under 'mis' the fuzz lobe is a CONTINUOUS lobe with an
        # analytic solid-angle pdf (sampling.fuzz_pdf): NEE estimates the
        # metal lobe too and both weight sites compete against the full
        # mixture density — exact balance weights, no delta approximation
        # (roughness == 0 stays the delta mirror).
        self.has_rough = scene.has_rough_metals
        # Checker texture (extension): recolor hits on a world-space 3-D
        # checkerboard — pure lane math (no table reads at all).
        # Statically gated like the other channels.
        self.has_checker = scene.has_checker
        # Image textures (extension, models/texture.py): per-lane texel
        # fetches from a packed atlas (gather_texels). The atlas is a
        # per-scene constant: a jnp constant in the oracle, a
        # global-memory operand in the GPU kernel (Pallas rejects
        # captured array constants) bound via bind_texture() before
        # tracing. Statically gated like the other channels.
        self.has_texture = scene.has_texture
        # Environment-map sky (extension, models/scene.Sky): miss shading
        # samples a texture by ray direction instead of the gradient.
        # Scene-level and static (texture id, intensity, atlas row range
        # are compile-time constants) — no per-primitive channel, so the
        # traversals are untouched; only bounce_step's miss branch and the
        # atlas operand (needs_atlas) change.
        self.has_sky = scene.has_sky_texture
        self.needs_atlas = scene.needs_atlas
        if self.needs_atlas:
            self.tex_size = scene.texture_size
            self.tex_rows = scene.texture_rows  # atlas rows per texture
            self.tex_atlas_host = scene.texture_atlas()
            self._tex_tab = None  # kernel-bound table ref, or None
            self._tex_direct = False
            # Bilinear magnification filter (static; 'nearest' compiles
            # the exact one-gather fetch). Texel coords wrap on all edges
            # (power-of-two sizes: wrap = AND with S-1), matching the
            # fract() tiling of the nearest path.
            self.tex_bilinear = scene.tex_bilinear
        if self.has_texture:
            # Static sweep bounds of the hit-recolor fetch: only rows of
            # textures PRIMITIVES reference (a sky-only texture's rows are
            # never recolor targets — each skipped row is ~4 vector ops
            # per bounce, gather_texels).
            prim_tids = sorted(
                scene.texture_index(p.material.texture)
                for _, p in scene.primitives if p.material.is_textured
            )
            self.tex_prim_lo = (prim_tids[0] - 1) * self.tex_rows
            self.tex_prim_hi = prim_tids[-1] * self.tex_rows
        # Normal maps (extension): a second mapped fetch perturbing the
        # shading normal (_apply_normal_map) — per-primitive channels like
        # the texture channels, with their own static sweep bounds.
        self.has_normal_map = scene.has_normal_map
        if self.has_normal_map:
            nm_tids = sorted(
                scene.texture_index(p.material.normal_map)
                for _, p in scene.primitives if p.material.is_normal_mapped
            )
            self.nm_prim_lo = (nm_tids[0] - 1) * self.tex_rows
            self.nm_prim_hi = nm_tids[-1] * self.tex_rows
        if self.has_sky:
            self.sky_tid = scene.texture_index(scene.sky.texture)
            self.sky_intensity = float(scene.sky.intensity)
        # Homogeneous participating medium (extension, models/scene.Fog):
        # scatter distances are sampled analytically, t = -ln(1-u)/sigma,
        # which importance-samples the transmittance EXACTLY — the path
        # throughput needs no explicit exp() bookkeeping at all (surviving
        # to the surface already has probability exp(-sigma t_hit)); only
        # NEE shadow segments, which are not distance-sampled, carry an
        # explicit transmittance factor. Isotropic phase (uniform-sphere
        # scatter directions). Fog parameters are compile-time constants
        # (static even in dynamic mode, like the light topology).
        self.has_fog = scene.has_fog
        if self.has_fog:
            self.fog_sigma = float(scene.fog.density)
            self.fog_albedo = tuple(
                float(c) for c in scene.fog.albedo
            )
            # Henyey-Greenstein anisotropy; 0 compiles the isotropic code
            # (bit-exact with the pre-anisotropy implementation).
            self.fog_g = float(scene.fog.g)
        # Traversal: the plain baked sweep ('baked'), the array-resident
        # fori_loop sweep ('array', ops/arrayscene.py — fixed code size for
        # any primitive count, the analog of the reference's storage-buffer
        # loop at shader.wgsl:248-294 / lib.rs:301-305), or the
        # block-culled accelerator ('grid', ops/accel.py). 'auto' resolves
        # to 'baked' below ARRAY_AUTO_THRESHOLD primitives and 'array'
        # above: the unrolled baked sweep wins at shipped scale (zero
        # memory traffic, 0/±1 constant folding) but its code size,
        # compile time, and sweep cost grow O(N) in unrolled code — the
        # array sweep compiles in O(1) and overtakes it well before
        # stress:1024. 'grid' and 'gathered' are opt-in (their module
        # docstrings give their status).
        assert accel in ("auto", "baked", "array", "grid", "gathered")
        if accel == "auto":
            n_prims = (len(scene.spheres) + len(scene.planes)
                       + len(scene.triangles))
            accel = "array" if n_prims > ARRAY_AUTO_THRESHOLD else "baked"
        self.accel = accel
        # dynamic=True swaps the baked-constant traversal for ops/dynamic's
        # array-driven DynPrims: geometry/material VALUES become traced
        # inputs (bind per trace via prims.bind), topology stays static.
        # dyn_animated (optional key set) folds the non-animated value
        # subset back to baked constants (see DynPrims).
        self.dynamic = dynamic
        if dynamic and accel == "gathered":
            raise ValueError(
                "accel='gathered' needs static geometry (the grid and "
                "primitive tables are host-built); use accel='array' for "
                "animated scenes at scale"
            )
        if dynamic:
            if accel == "array":
                # Animated scenes at scale: the fori-sweep traversal over
                # RUNTIME SoA values (derived in-graph) — O(1) code size,
                # unlike DynPrims' per-primitive unrolling. The animated
                # key subset is ignored here (nothing folds: every value
                # is an array element either way).
                from . import arrayscene

                self.prims = arrayscene.ArrayDynPrims(scene)
            else:
                from . import dynamic as dyn_mod

                self.prims = dyn_mod.DynPrims(scene, animated=dyn_animated)
        elif accel == "grid":
            from . import accel as accel_mod

            self.prims = accel_mod.CulledPrims(scene)
        elif accel == "gathered":
            # Per-lane gathered grid walks (ops/gathered.py): fewer
            # primitive tests per ray via per-lane table fetches — a
            # consumption of the reference's dead uniform grid
            # (lib.rs:158-246).
            from . import gathered as gathered_mod

            self.prims = gathered_mod.GatheredPrims(scene)
        elif accel == "array":
            from . import arrayscene

            self.prims = arrayscene.ArrayPrims(scene)
        else:
            self.prims = geom.ScenePrims(scene)
        self.width = scene.width
        self.height = scene.height
        self.spp = scene.samples_per_pixel
        self.max_depth = scene.max_depth
        self.base_samples = (
            base_quota if base_quota is not None else base_sample_count(self.spp)
        )

        # Stratified pixel jitter (extension, scene-level like
        # texture_filter — models/scene.py `sampler`): BASE-phase sample i
        # lands in cell i mod g^2 of a g x g sub-pixel grid, jittered
        # within the cell (stratify_jitter). g is the largest power of two
        # with g^2 dividing the base count, so the base phase covers every
        # cell exactly base/g^2 times — aggregate jitter coverage is
        # EXACTLY uniform and the estimator stays unbiased (base >= 4
        # guarantees g >= 2). Adaptive EXTRA samples keep the reference's
        # independent jitter: their per-pixel counts are data-dependent,
        # so no fixed grid covers them exactly — stratifying them would
        # bias sub-pixel coverage toward low cells. Like auto-chunking,
        # stratification requires owning the whole budget (base_quota is
        # None): a sample-split shard renders a runtime share of the base
        # phase under a decorrelated seed (parallel/mesh.py), where no
        # static grid divides every share — those tracers fall back to
        # reference jitter on every backend (documented in PARITY.md).
        # strat_g == 1 compiles the exact reference jitter statically.
        self.strat_g = 1
        if scene.sampler == "stratified":
            if base_quota is None:
                g = 1
                while (4 * g * g <= self.base_samples
                       and self.base_samples % (4 * g * g) == 0):
                    g *= 2
                self.strat_g = g
                if g == 1:
                    _note_stratified_fallback(
                        "base sample count %d is not divisible by 4 — "
                        "no sub-pixel grid covers it evenly; using "
                        "reference jitter" % self.base_samples)
            else:
                _note_stratified_fallback(
                    "sample-split shards render shard-local sample indices "
                    "under decorrelated seeds — absolute strata don't "
                    "survive the split; using reference jitter")

        # Heavy-pixel chunk-split resolution (see the CHUNK_GOLDEN comment
        # block above). 'auto' turns it on only for the array traversal at
        # >= CHUNK_AUTO_THRESHOLD primitives (small scenes that merely force accel='array' keep the sequential chains
        # and stay bit-identical to the baked sweep), and only when this
        # tracer owns the whole budget (the sample-split mesh path passes
        # base_quota and manages its own runtime shares; chunking there
        # would compose two different sub-chain derivations).
        n_prims = (len(scene.spheres) + len(scene.planes)
                   + len(scene.triangles))
        auto_chunk = (self.accel == "array"
                      and n_prims >= CHUNK_AUTO_THRESHOLD
                      and base_quota is None)
        if chunk_base == "auto":
            chunk_base = ARRAY_CHUNK_BASE if auto_chunk else None
        if chunk_extra == "auto":
            chunk_extra = ARRAY_CHUNK_EXTRA if auto_chunk else None
        if chunk_base is not None and int(chunk_base) >= self.base_samples:
            chunk_base = None  # one chunk = the sequential chain
        max_extra = self.spp - self.base_samples
        if chunk_extra is not None and int(chunk_extra) >= max(max_extra, 0):
            chunk_extra = None
        self.chunk_base = None if chunk_base is None else int(chunk_base)
        self.chunk_extra = None if chunk_extra is None else int(chunk_extra)

        # Thin-lens depth of field (extension — the reference is pinhole):
        # statically gated, so aperture == 0 adds no ops and no RNG draws
        # (exact reference parity).
        self.aperture = float(scene.camera.aperture)
        self.focus_distance = float(scene.camera.focus_distance)

        # Static f32 camera intrinsics (shader.wgsl:522-527). Computed in
        # f32 like the shader does per-sample.
        self.half_height = float(np.tan(np.float32(scene.fov_rad) / np.float32(2)))
        self.half_width = float(
            np.float32(scene.width) / np.float32(scene.height)
        ) * self.half_height
        self.inv_char_aspect = float(
            np.float32(1.0) / np.float32(scene.camera.char_aspect_ratio)
        )

        # Static light list (shader.wgsl:342-391 loops all primitives and
        # skips non-emissive + planes; the skip is compile-time here). In
        # dynamic mode only the TOPOLOGY is static — values are read from
        # the bound arrays per trace (_lights_now).
        if dynamic:
            self.lights = ()
            self.n_lights = len(self.prims.light_topology)
            self._init_light_sample()
            return
        self.lights = []
        for tag, p in scene.lights:
            if tag == scene_mod.SPHERE:
                self.lights.append(
                    _Light(tag, (V3(*p.center), float(p.radius)), p.material.emission)
                )
            else:  # TRIANGLE
                e1, e2, normal, area = geom._tri_edges_f32(p)
                self.lights.append(
                    _Light(
                        tag,
                        (V3(*p.v0), V3(*p.v1), V3(*p.v2), V3(*normal), area),
                        p.material.emission,
                    )
                )
        self.n_lights = len(self.lights)
        self._init_light_sample()

    def _init_light_sample(self):
        """Resolve the scene's NEE light-sampling strategy (extension,
        models/scene.py `light_sample`). 'all' (default) keeps the
        reference's one-shadow-ray-per-light loop — the traced program is
        untouched, bit-exact. 'uniform'/'power' cast ONE shadow ray per
        NEE event at a light picked per lane (see _one_light_nee),
        weighted by 1/p(pick): the per-bounce occlusion cost drops from
        n_lights primitive sweeps to one. Scenes with <= 1 NEE light
        normalize to 'all' (the loop is already a single sweep; a
        selection draw would change the RNG chains for nothing).

        `nee_sweeps` is the per-iteration shadow-sweep (= owed shadow
        ray) count every accounting site charges: the rays metric
        (bounce_step), the oracle occupancy denominator (render_frame),
        and the kernel/mesh scheduler capacities (ops/pallas_kernel.py,
        parallel/mesh.py) — 'all' keeps the historic 1 + n_lights."""
        mode = self.scene.light_sample
        self.one_light = mode != "all" and self.n_lights > 1
        self.light_mode = mode if self.one_light else "all"
        self.nee_sweeps = 1 if self.one_light else self.n_lights

    def _light_pick(self, lights):
        """Per-light pick probabilities of the one-light NEE modes.

        Returns (probs, cums, inv_total): `probs[i]` the probability of
        picking light i, `cums` its inclusive running sum (the selection
        thresholds), `inv_total` the reciprocal of the total emitted
        power (consumed by the 'power' mode's BSDF-side MIS density,
        where the hit light's area term cancels — see bounce_step).
        'uniform' picks 1/L each; 'power' picks proportionally to
        Rec.709 luminance x surface area (the same luma weights the
        tonemapper ranks glyphs by). Baked scenes fold everything to
        Python floats at trace time; dynamic scenes compute the same
        expressions over traced scalars — one shared code path, so
        baked and template-value dynamic traces agree exactly."""
        n = len(lights)
        if self.light_mode == "uniform":
            probs = [1.0 / n] * n
            inv_total = None
        else:
            powers = []
            for light in lights:
                e = light.emission
                ex, ey, ez = (e.x, e.y, e.z) if isinstance(e, V3) else e
                lum = _LUM[0] * ex + _LUM[1] * ey + _LUM[2] * ez
                if light.kind == scene_mod.SPHERE:
                    r = light.data[1]
                    area = 4.0 * sampling.PI * r * r
                else:
                    area = light.data[4]
                powers.append(lum * area)
            total = powers[0]
            for pw in powers[1:]:
                total = total + pw
            # Zero total power is unreachable for baked scenes (is_light
            # requires emission above LIGHT_POWER_EPS) but an animator
            # could drive every emission to ~0 at runtime: the guard
            # keeps the math finite (contributions are ~0 anyway).
            if isinstance(total, float):
                total = max(total, 1e-20)
            else:
                total = jnp.maximum(total, 1e-20)
            inv_total = 1.0 / total
            probs = [pw * inv_total for pw in powers]
        cums = []
        acc = 0.0
        for pr in probs:
            acc = acc + pr
            cums.append(acc)
        return probs, cums, inv_total

    # ------------------------------------------------------------------
    # Image textures (extension)
    # ------------------------------------------------------------------

    def bind_texture(self, tab, direct: bool = False) -> None:
        """Bind the texel-atlas ref for an in-kernel trace -- Pallas
        rejects captured array constants, so the kernel builder passes the
        atlas as an operand and binds it here before tracing the kernel
        body; `direct` fetches by indexed loads (gather_texels). Unbound
        (oracle) traces read the atlas as a jnp constant. No-op for
        atlas-free scenes."""
        if self.needs_atlas:
            self._tex_tab = tab
            self._tex_direct = direct

    def _texture_table(self):
        if self._tex_tab is not None:
            return self._tex_tab
        return jnp.asarray(self.tex_atlas_host)

    @staticmethod
    def _unpack_texel(packed) -> V3:
        """models/texture.py packing: ``r<<16 | g<<8 | b`` -> [0,1] V3."""
        q = 1.0 / 255.0
        return V3(
            jax.lax.shift_right_logical(packed, 16).astype(jnp.float32) * q,
            jnp.bitwise_and(jax.lax.shift_right_logical(packed, 8),
                            255).astype(jnp.float32) * q,
            jnp.bitwise_and(packed, 255).astype(jnp.float32) * q,
        )

    def _fetch_texel(self, idx, lo, hi):
        """Per-lane atlas fetch + rgb unpack, sweeping atlas rows [lo, hi)
        — static bounds, see gather_texels. Returns a [0,1] V3."""
        return self._unpack_texel(
            gather_texels(self._texture_table(), idx, hi, lo,
                          self._tex_direct))

    def _fetch_bilinear(self, base, u, v, lo, hi):
        """2x2-texel bilinear fetch (texture_filter='bilinear'): ``u``/
        ``v`` are the wrapped [0,1) uv, ``base`` the flat atlas index of
        the texture's texel 0 (per-lane i32, may be negative on
        untextured lanes — clamped like the nearest fetch). Samples sit
        at texel CENTERS ((i+0.5)/S), so the blend neighborhood is
        floor(u*S - 0.5) and its +1 neighbors, both wrapped (S is a
        power of two: wrap = AND with S-1; floor(-0.5..0) = -1 wraps to
        S-1 in two's complement). The four gathers share each atlas
        row's broadcast (gather_texels_multi)."""
        s = float(self.tex_size)
        m = self.tex_size - 1
        x = u * s - 0.5
        y = v * s - 0.5
        x0 = jnp.floor(x)
        y0 = jnp.floor(y)
        fx = x - x0
        fy = y - y0
        iu0 = jnp.bitwise_and(x0.astype(jnp.int32), m)
        iv0 = jnp.bitwise_and(y0.astype(jnp.int32), m)
        iu1 = jnp.bitwise_and(iu0 + 1, m)
        iv1 = jnp.bitwise_and(iv0 + 1, m)
        r0 = base + iv0 * self.tex_size
        r1 = base + iv1 * self.tex_size
        packs = gather_texels_multi(
            self._texture_table(),
            tuple(jnp.maximum(i, 0)
                  for i in (r0 + iu0, r0 + iu1, r1 + iu0, r1 + iu1)),
            hi, lo, self._tex_direct,
        )
        t00, t01, t10, t11 = (self._unpack_texel(p) for p in packs)
        top = t00 + (t01 - t00) * fx
        bot = t10 + (t11 - t10) * fx
        return top + (bot - top) * fy

    def _spherical_uv(self, n: V3):
        """Latitude/longitude uv of a unit vector — the textured-sphere
        mapping, shared by the sky fetch (sampling.atan2, a polynomial;
        ROADMAP D2)."""
        half_inv_pi = 0.5 / sampling.PI
        u = 0.5 + sampling.atan2(n.z, n.x) * half_inv_pi
        ny = jnp.clip(n.y, -1.0, 1.0)
        v = 0.5 + sampling.atan2(
            ny, jnp.sqrt(jnp.maximum(1.0 - ny * ny, 0.0))
        ) * (2.0 * half_inv_pi)
        return u, v

    def _sky_radiance(self, d: V3) -> V3:
        """Environment-map miss shading (extension): sample the sky
        texture by ray direction — spherical uv of the (unit) direction,
        nearest texel, scaled by the scene's sky intensity. Replaces
        sky_color() when scene.sky is set; the fetch sweeps ONLY the sky
        texture's atlas rows (static bounds)."""
        u, v = self._spherical_uv(d)
        lo = (self.sky_tid - 1) * self.tex_rows
        if self.tex_bilinear:
            # base is a static scalar here (one known texture) — it
            # broadcasts against the per-lane texel rows.
            texel = self._fetch_bilinear(lo * 128, u, v,
                                         lo, lo + self.tex_rows)
        else:
            s = float(self.tex_size)
            smax = self.tex_size - 1
            # u is already in [0,1) from atan2; guard the v=1 pole exactly
            # like the recolor clamps its top texel.
            iu = jnp.minimum(jnp.floor(u * s).astype(jnp.int32), smax)
            iv = jnp.minimum(jnp.floor(v * s).astype(jnp.int32), smax)
            idx = lo * 128 + iv * self.tex_size + iu
            texel = self._fetch_texel(idx, lo, lo + self.tex_rows)
        return texel * self.sky_intensity

    def _mapped_texel(self, hit: geom.Hit, signed_id, scale, lo, hi) -> V3:
        """One per-lane texel sample at a hit, mapped by the channel's
        sign convention (models/scene.py texture_channel/normal_channel):
        +id = dominant-axis planar projection of the world-space hit point
        (the natural wall/floor mapping, same world-space spirit as the
        checker), -id = spherical latitude/longitude of the hit normal
        (which IS the unit radial direction on a sphere). `scale` tiles
        the uv; [lo, hi) bound the swept atlas rows statically; the fetch
        honors the scene's texture_filter. Unmapped lanes (id 0) compute a
        negative index; max() clamps it to texel 0 (a valid but irrelevant
        fetch — or, when the swept range excludes row 0, an unswept index
        returning 0) and the CALLER's select drops the result there.

        KNIFE-EDGE caveat (shared with the checker recolor in
        bounce_step): texel-grid floor() parity can flip an isolated
        boundary pixel between programs; decisions stay exact below the
        RR start depth, which is what the texture tests pin."""
        n, p = hit.normal, hit.p
        # Planar: project p on the plane of the dominant |n| axis. Axis
        # conventions: x-dominant -> (z, y), y-dominant -> (x, z),
        # z-dominant -> (x, y).
        ax, ay, az = jnp.abs(n.x), jnp.abs(n.y), jnp.abs(n.z)
        xdom = (ax >= ay) & (ax >= az)
        ydom = (~xdom) & (ay >= az)
        u_pl = jnp.where(xdom, p.z, p.x)
        v_pl = jnp.where(xdom, p.y, jnp.where(ydom, p.z, p.y))
        # Spherical: latitude/longitude of the unit normal.
        u_sp, v_sp = self._spherical_uv(n)
        spherical = signed_id < 0.0
        u = jnp.where(spherical, u_sp, u_pl) * scale
        v = jnp.where(spherical, v_sp, v_pl) * scale
        u = u - jnp.floor(u)
        v = v - jnp.floor(v)
        tid = jnp.abs(signed_id).astype(jnp.int32)
        base = (tid - 1) * (self.tex_rows * 128)
        if self.tex_bilinear:
            return self._fetch_bilinear(base, u, v, lo, hi)
        s = float(self.tex_size)
        smax = self.tex_size - 1
        iu = jnp.minimum(jnp.floor(u * s).astype(jnp.int32), smax)
        iv = jnp.minimum(jnp.floor(v * s).astype(jnp.int32), smax)
        return self._fetch_texel(
            jnp.maximum(base + iv * self.tex_size + iu, 0), lo, hi)

    def _texture_recolor(self, hit: geom.Hit) -> geom.Hit:
        """REPLACE hit.color with the sampled texel on textured lanes
        (_mapped_texel). Runs before NEE and the scatter, so both consume
        the textured albedo. The sweep covers only rows of
        primitive-COLOR-referenced textures (tex_prim_lo/hi — sky-only or
        normal-map-only textures are excluded statically)."""
        ti = hit.tex_index  # f32 signed id, 0 = untextured
        texel = self._mapped_texel(hit, ti, hit.tex_scale,
                                   self.tex_prim_lo, self.tex_prim_hi)
        return hit._replace(color=vm.where(ti != 0.0, texel, hit.color))

    def _apply_normal_map(self, hit: geom.Hit) -> geom.Hit:
        """Perturb the shading normal from a tangent-space normal map
        (extension): texel rgb -> [-1,1] xyz (z = up along the geometric
        normal), tangential xy deflection scaled by the per-primitive
        strength, re-normalized. The tangent frame follows the uv mapping
        (_mapped_texel): planar lanes take the two world axes the uv
        projects onto; spherical lanes take the longitude tangent
        (-n.z, 0, n.x)/len with its bitangent cross(n, T) (singular at the
        poles — guarded to +x there, where the map's own uv is singular
        anyway). Replaces hit.normal AFTER the front-face flip, so NEE
        cosines, the mirror/glass reflections, and the cosine-hemisphere
        scatter all see the perturbed normal; `front` (and the ray-side
        logic built on it) stays geometric. The perturbed z component is
        clamped to stay above the surface (a strength-independent safety:
        authored maps keep z > 0)."""
        ni = hit.nm_index  # f32 signed id, 0 = unmapped
        texel = self._mapped_texel(hit, ni, hit.nm_scale,
                                   self.nm_prim_lo, self.nm_prim_hi)
        tn = texel * 2.0 - V3(1.0, 1.0, 1.0)
        n = hit.normal
        # Planar frames by dominant axis (must match _mapped_texel's
        # (u, v) axis pairs so the map reads as authored):
        #   x-dominant: u = p.z, v = p.y -> T = +z, B = +y
        #   y-dominant: u = p.x, v = p.z -> T = +x, B = +z
        #   z-dominant: u = p.x, v = p.y -> T = +x, B = +y
        ax, ay, az = jnp.abs(n.x), jnp.abs(n.y), jnp.abs(n.z)
        xdom = (ax >= ay) & (ax >= az)
        ydom = (~xdom) & (ay >= az)
        t_pl = vm.where(xdom, V3(0.0, 0.0, 1.0),
                        vm.splat(jnp.zeros_like(n.x)) + V3(1.0, 0.0, 0.0))
        b_pl = vm.where(xdom | (~ydom),
                        vm.splat(jnp.zeros_like(n.x)) + V3(0.0, 1.0, 0.0),
                        vm.splat(jnp.zeros_like(n.x)) + V3(0.0, 0.0, 1.0))
        # Spherical frame: longitude tangent + its bitangent.
        len2 = n.x * n.x + n.z * n.z
        inv = jax.lax.rsqrt(jnp.maximum(len2, 1e-12))
        pole = len2 < 1e-12
        t_sp = V3(jnp.where(pole, 1.0, -n.z * inv),
                  jnp.zeros_like(n.x),
                  jnp.where(pole, 0.0, n.x * inv))
        b_sp = vm.cross(n, t_sp)
        spherical = ni < 0.0
        t_v = vm.where(spherical, t_sp, t_pl)
        b_v = vm.where(spherical, b_sp, b_pl)
        ns = hit.nm_strength
        raw = (t_v * (tn.x * ns) + b_v * (tn.y * ns)
               + n * jnp.maximum(tn.z, 1e-3))
        perturbed = vm.normalize(raw)
        return hit._replace(
            normal=vm.where(ni != 0.0, perturbed, n))

    # ------------------------------------------------------------------
    # NEE direct lighting (shader.wgsl:338-436)
    # ------------------------------------------------------------------

    def direct_light(self, state, p: V3, normal: V3, color: V3, att: V3, gate,
                     refl=None, fog=None, rough=None):
        """One NEE estimate per light. Returns (state', direct V3).

        The result is fully masked internally (occlusion + cosine terms);
        the caller additionally gates by its live-lane mask. `gate` is that
        live mask: RNG state advances only on lanes whose reference thread
        would reach sample_direct_lighting (it is only called on hits,
        shader.wgsl:458).

        `refl` (lanes): the hit's delta-branch selection probability —
        reflectivity, plus transparency when the scene has dielectrics
        (both are delta lobes). Consumed only by the 'mis' transport,
        whose balance weight needs the BSDF's continuous-part pdf
        (1 - refl) * cos/pi for the sampled light direction.

        `fog` (optional, has_fog scenes): the 3-tuple
        (scatter_mask, scatter_point V3, d_in V3) — `scatter_mask` marks
        lanes whose bounce is a volume scattering event, `scatter_point`
        is their sampled in-medium vertex, and `d_in` is the incoming
        propagation direction, consumed by the anisotropic
        Henyey-Greenstein phase evaluation (per sampled light direction).
        Scatter lanes estimate direct light from the scatter point with
        the phase function (no cosine, no surface offset); ALL lanes'
        contributions additionally carry the shadow segment's
        transmittance exp(-sigma * light_distance). Under 'mis' the
        balance weight competes NEE against the phase lobe on scatter
        lanes, with the BSDF/phase strategy's density carrying the
        medium's no-collision probability exp(-sigma * t) (distance
        sampling must not scatter before the light for a BSDF ray to
        reach it).

        `rough` (optional, has_rough scenes under 'mis'): the 3-tuple
        (roughness, reflectivity, mirror_dir V3) of the hit — the metal
        fuzz lobe is CONTINUOUS (its solid-angle pdf about the perfect
        mirror axis is analytic, sampling.fuzz_pdf), so NEE at a
        fuzzy-metal surface additionally estimates the metal lobe and the
        balance weight competes against the full mixture pdf
        (1 - refl)*cos/pi + reflectivity*fuzz_pdf. reflectivity rides
        separately from `refl` (which adds transparency — glass stays a
        delta lobe).
        """
        zeros = jnp.zeros_like(p.x)
        direct = vm.splat(zeros)
        brdf = color * (1.0 / sampling.PI)  # Lambertian albedo/pi (shader.wgsl:412)
        if fog is not None:
            scatter, sp, d_in = fog
            # Volume points sample direct light from the scatter point
            # with the phase function instead of the Lambert lobe (and
            # without the surface-normal shadow offset below). Isotropic
            # (g == 0): a constant albedo/4pi; anisotropic: evaluated
            # per light direction inside the loop below.
            p = vm.where(scatter, sp, p)
            if self.fog_g == 0.0:
                phase = V3(*(c * (1.0 / (4.0 * sampling.PI))
                             for c in self.fog_albedo))
                brdf = vm.where(scatter, vm.splat(zeros) + phase, brdf)

        lights = (
            [_Light(*l) for l in self.prims.light_list()]
            if self.dynamic else self.lights
        )
        if self.one_light:
            # Single-light NEE (extension, scene `light_sample`): one
            # picked light, one occlusion sweep, estimator weighted by
            # 1/p(pick) — see _one_light_nee.
            return self._one_light_nee(
                state, p, normal, brdf, att, gate, lights,
                refl=refl, fog=fog, rough=rough,
            )
        # fuse_nee: both lights' shadow sweeps share their origin, so the
        # per-primitive origin-dependent subexpressions can be computed
        # once for both payloads (geometry.occluded2). The occlusion tests
        # are deferred out of the light loop; contributions accumulate in
        # the same order with the same values — bit-identical.
        fuse = (
            self.fuse_nee and len(lights) == 2 and fog is None
            and getattr(self.prims, "occluded2", None) is not None
        )
        deferred = []
        for light in lights:
            if light.kind == scene_mod.SPHERE:
                center, radius = light.data
                state, lp, ln, area = sampling.sphere_light_point(
                    state, center, radius, gate
                )
            else:
                v0, v1, v2, ln, area = light.data
                state, lp = sampling.triangle_light_point(state, v0, v1, v2, gate)

            lvec = lp - p
            ldist = vm.length(lvec)
            ldir = lvec / ldist

            shadow_o = p + normal * geom.RAY_EPS  # offset along normal (wgsl:399)
            if fog is not None:
                shadow_o = vm.where(scatter, p, shadow_o)  # no surface
            if self.transport == "mis":
                # The reference measures light_distance from the UNOFFSET
                # hit point but casts from the offset origin (wgsl:394-400),
                # leaving the target light's own intersection within f32
                # noise of t_max = ldist - eps whenever the light is near
                # the surface normal (margin eps*(1 - cos_s) -> 0): NEE
                # then self-blocks on exactly the shadow rays that matter.
                # MIS's balance weights assume NEE covers front-face
                # lights, so mis mode measures the segment from the offset
                # origin itself — the eps margin is then honest. reference/
                # unbiased keep the quirk (parity).
                lvec_s = lp - shadow_o
                ldist_s = vm.length(lvec_s)
                sh_dir, sh_tmax = lvec_s / ldist_s, ldist_s - geom.RAY_EPS
            else:
                sh_dir, sh_tmax = ldir, ldist - geom.RAY_EPS
            if fuse:
                blocked = None  # deferred to the fused post-loop sweep
            else:
                blocked = self.prims.occluded(
                    shadow_o, sh_dir, geom.RAY_EPS, sh_tmax, mask=gate,
                )

            cos_s = jnp.maximum(0.0, vm.dot(normal, ldir))
            if fog is not None:
                cos_s = jnp.where(scatter, 1.0, cos_s)  # phase has no cos
            cos_l = jnp.maximum(0.0, vm.dot(ln, -ldir))
            ok = (cos_s > 0.0) & (cos_l > 0.0)
            if not fuse:
                ok = (~blocked) & ok

            geom_term = (cos_s * cos_l) / (ldist * ldist)
            weight = geom_term * area
            if fog is not None:
                # Shadow segments are not distance-sampled, so they carry
                # the medium's transmittance explicitly (for surface AND
                # volume senders alike).
                weight = weight * jnp.exp(-self.fog_sigma * ldist)
            if self.transport == "mis":
                # Balance heuristic vs the BSDF strategy for this direction:
                # p_nee (solid angle) = t^2 / (cos_l * area), p_bsdf =
                # (1 - refl) * cos_s / pi. Applied before the reference's
                # firefly clamp so the clamp bounds the actual estimator.
                #
                # The extra (1 - refl) factor makes NEE target the actual
                # path-traced BSDF mixture refl*delta + (1-refl)*Lambertian
                # — the reference's NEE evaluates a FULL Lambertian lobe on
                # every surface (shader.wgsl:412) while its diffuse branch
                # carries the (1-refl) selection probability, so its two
                # direct-light estimators measure different integrands on
                # reflective surfaces (a pure mirror gets a Lambertian NEE
                # ghost). MIS requires one integrand; the physical one.
                p_l = (ldist * ldist) / (jnp.maximum(cos_l, 1e-8) * area)
                p_b = (1.0 - refl) * cos_s * (1.0 / sampling.PI)
                mix = 1.0 - refl
                if rough is not None:
                    # Metal-lobe extension (has_rough scenes): the fuzz
                    # lobe's analytic pdf about the mirror axis joins the
                    # mixture density AND the NEE integrand gains the
                    # metal lobe (BSDF*cos = color * fuzz_pdf). contrib
                    # below scales (color/pi) by cos_s * mix, i.e. by
                    # mix * pi/cos_s per unit pdf — so the metal term
                    # enters mix as metal * pi / cos_s (cos_s > 0 on every
                    # lane `ok` keeps; fuzz directions with cos_s <= 0 are
                    # absorbed, so both strategies drop them consistently).
                    f_r, m_refl, m_dir = rough
                    metal = m_refl * sampling.fuzz_pdf(
                        vm.dot(m_dir, ldir), f_r
                    )
                    p_b = p_b + metal
                    mix = mix + metal * sampling.PI / jnp.maximum(
                        cos_s, 1e-8
                    )
                if fog is not None:
                    # Volume senders compete against the PHASE lobe (no
                    # surface mixture factor), and in a medium the
                    # BSDF/phase strategy only produces this emitter vertex
                    # if its distance draw overshoots the light — its
                    # density carries the no-collision probability
                    # exp(-sigma t). NEE's density does not (it carries the
                    # transmittance as an explicit weight factor instead,
                    # above).
                    ph_pdf = sampling.hg_phase(vm.dot(d_in, ldir), self.fog_g)
                    p_b = jnp.where(scatter, ph_pdf, p_b)
                    mix = jnp.where(scatter, 1.0, mix)
                    p_b = p_b * jnp.exp(-self.fog_sigma * ldist)
                weight = weight * (
                    mix * p_l / jnp.maximum(p_l + p_b, 1e-20)
                )
            emi = (light.emission if isinstance(light.emission, V3)
                   else V3(*light.emission))
            brdf_l = brdf
            if fog is not None and self.fog_g != 0.0:
                # Anisotropic phase toward THIS light's sampled direction.
                ph = sampling.hg_phase(vm.dot(d_in, ldir), self.fog_g)
                brdf_l = vm.where(
                    scatter, V3(*self.fog_albedo) * ph, brdf,
                )
            contrib = (brdf_l * emi) * (att * weight)
            contrib = vm.min_components(contrib, NEE_CLAMP)  # wgsl:420-427
            if fuse:
                deferred.append((shadow_o, sh_dir, sh_tmax, ok, contrib))
            else:
                direct = direct + vm.where(ok, contrib, vm.splat(zeros))

        if fuse:
            (o1, d1, tm1, ok1, c1), (_, d2, tm2, ok2, c2) = deferred
            b1, b2 = self.prims.occluded2(
                o1, d1, tm1, d2, tm2, t_min=geom.RAY_EPS, mask=gate,
            )
            direct = direct + vm.where((~b1) & ok1, c1, vm.splat(zeros))
            direct = direct + vm.where((~b2) & ok2, c2, vm.splat(zeros))
        return state, direct

    def _one_light_nee(self, state, p, normal, brdf, att, gate, lights,
                       refl=None, fog=None, rough=None):
        """One NEE estimate from ONE picked light (extension, scene
        `light_sample: uniform|power`). Returns (state', direct V3).

        The reference's NEE loop casts one shadow ray per light per
        bounce (shader.wgsl:338-436) — per-bounce occlusion cost O(L) in
        the light count, each sweep touching every primitive. Here each
        lane picks light i with probability p_i (uniform, or proportional
        to Rec.709 luminance x area — _light_pick) and casts a single
        shadow ray, weighting the estimate by 1/p_i: the expectation is
        exactly the full loop's sum, so the estimator stays unbiased,
        while the per-bounce cost drops to ONE sweep — O(1) in L.

        RNG: three gated draws per NEE event in canonical order — the
        selection uniform, then ONE point-sampling pair (both light kinds
        consume exactly two uniforms, sampling.sphere/triangle_light_point,
        so the pair serves whichever light each lane picked — no
        per-kind draw divergence). `gate` is the caller's nee_gate, the
        same condition that gates the 'all' loop's draws.

        The picked light's parameters materialize by one-hot selects over
        the (few) lights — per light ~6 V3 selects, vs a whole primitive
        sweep per light in 'all' mode. Everything downstream (shadow
        offset, occlusion, cosines, fog transmittance / phase, MIS
        balance weight, NEE clamp) is the 'all' loop body verbatim, with
        two one-light deltas: the contribution carries the 1/p_i factor
        (applied BEFORE the reference's firefly clamp, so the clamp
        bounds the actual added value), and under 'mis' the NEE density
        gains the pick probability — p_l = p_i * t^2/(cos_l * area),
        mirrored by the BSDF-side emitter-hit weight in bounce_step, so
        the balance weights stay an exact partition of unity
        (non-overlapping light surfaces put all pick density on the one
        light the sampled point lies on)."""
        zeros = jnp.zeros_like(p.x)
        if fog is not None:
            # `p`/`brdf` were already scatter-adjusted by direct_light;
            # only the mask and incoming direction are consumed here.
            scatter, _sp, d_in = fog

        probs, cums, _inv_total = self._light_pick(lights)
        state, u_sel = prng.next_f32(state, gate)
        state, r1, r2 = prng.next_f32_pair(state, gate)

        # Picked index as an f32 plane (small ints are exact in f32):
        # idx = #{thresholds <= u_sel}. Baked thresholds are Python-float
        # constants; dynamic ones are traced scalars.
        idxf = zeros
        for c in cums[:-1]:
            idxf = idxf + jnp.where(u_sel >= c, 1.0, 0.0)

        # Shared point-sampling forms — functions of the draws alone, so
        # one instance serves every light of that kind.
        if any(light.kind == scene_mod.SPHERE for light in lights):
            cos_theta = 1.0 - 2.0 * r1  # sampling.sphere_light_point
            sin_theta = jnp.sqrt(1.0 - cos_theta * cos_theta)
            phi = sampling.TWO_PI * r2
            local = V3(sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi),
                       cos_theta)
        if any(light.kind != scene_mod.SPHERE for light in lights):
            sqrt_r1 = jnp.sqrt(r1)  # sampling.triangle_light_point
            bu = 1.0 - sqrt_r1
            bv = r2 * sqrt_r1

        lp = vm.splat(zeros)
        ln = vm.splat(zeros)
        emi = vm.splat(zeros)
        area = zeros
        psel = zeros
        for i, light in enumerate(lights):
            m = idxf == float(i)
            if light.kind == scene_mod.SPHERE:
                center, radius = light.data
                cand = center + local * radius
                ln_i = local
                a_i = 4.0 * sampling.PI * radius * radius
            else:
                v0, v1, v2, ln_i, a_i = light.data
                cand = v0 * (1.0 - bu - bv) + v1 * bu + v2 * bv
            lp = vm.where(m, cand, lp)
            ln = vm.where(m, ln_i, ln)
            e = light.emission
            emi = vm.where(m, e if isinstance(e, V3) else V3(*e), emi)
            area = jnp.where(m, a_i, area)
            psel = jnp.where(m, probs[i], psel)
        psel = jnp.maximum(psel, 1e-12)

        # ---- the 'all' loop body, for the picked light ----
        lvec = lp - p
        ldist = vm.length(lvec)
        ldir = lvec / ldist

        shadow_o = p + normal * geom.RAY_EPS  # offset along normal (wgsl:399)
        if fog is not None:
            shadow_o = vm.where(scatter, p, shadow_o)  # no surface
        if self.transport == "mis":
            # Honest eps margin from the offset origin — see the 'all'
            # loop's self-block note (direct_light).
            lvec_s = lp - shadow_o
            ldist_s = vm.length(lvec_s)
            sh_dir, sh_tmax = lvec_s / ldist_s, ldist_s - geom.RAY_EPS
        else:
            sh_dir, sh_tmax = ldir, ldist - geom.RAY_EPS
        blocked = self.prims.occluded(
            shadow_o, sh_dir, geom.RAY_EPS, sh_tmax, mask=gate,
        )

        cos_s = jnp.maximum(0.0, vm.dot(normal, ldir))
        if fog is not None:
            cos_s = jnp.where(scatter, 1.0, cos_s)  # phase has no cos
        cos_l = jnp.maximum(0.0, vm.dot(ln, -ldir))
        ok = (~blocked) & (cos_s > 0.0) & (cos_l > 0.0)

        geom_term = (cos_s * cos_l) / (ldist * ldist)
        weight = geom_term * area * (1.0 / psel)  # 1/p(pick) estimator
        if fog is not None:
            weight = weight * jnp.exp(-self.fog_sigma * ldist)
        if self.transport == "mis":
            # Balance heuristic — identical to the 'all' loop except the
            # NEE density carries the pick probability.
            p_l = psel * (ldist * ldist) / (
                jnp.maximum(cos_l, 1e-8) * area
            )
            p_b = (1.0 - refl) * cos_s * (1.0 / sampling.PI)
            mix = 1.0 - refl
            if rough is not None:
                f_r, m_refl, m_dir = rough
                metal = m_refl * sampling.fuzz_pdf(
                    vm.dot(m_dir, ldir), f_r
                )
                p_b = p_b + metal
                mix = mix + metal * sampling.PI / jnp.maximum(
                    cos_s, 1e-8
                )
            if fog is not None:
                ph_pdf = sampling.hg_phase(vm.dot(d_in, ldir), self.fog_g)
                p_b = jnp.where(scatter, ph_pdf, p_b)
                mix = jnp.where(scatter, 1.0, mix)
                p_b = p_b * jnp.exp(-self.fog_sigma * ldist)
            weight = weight * (
                mix * p_l / jnp.maximum(p_l + p_b, 1e-20)
            )
        brdf_l = brdf
        if fog is not None and self.fog_g != 0.0:
            ph = sampling.hg_phase(vm.dot(d_in, ldir), self.fog_g)
            brdf_l = vm.where(scatter, V3(*self.fog_albedo) * ph, brdf)
        contrib = (brdf_l * emi) * (att * weight)
        contrib = vm.min_components(contrib, NEE_CLAMP)  # wgsl:420-427
        direct = vm.where(ok, contrib, vm.splat(zeros))
        return state, direct

    # ------------------------------------------------------------------
    # One wavefront bounce (the body of shader.wgsl:444-493)
    # ------------------------------------------------------------------

    def bounce_step(self, state, o: V3, d: V3, att: V3, acc: V3, alive,
                    bounce_idx, rays, emit_info):
        """Advance every live lane by one bounce.

        `bounce_idx` is the bounce counter — a traced scalar in the lockstep
        sample loop, or a per-lane i32 vector in the path-regeneration
        driver (identical semantics; it only feeds the Russian-roulette
        `i > 3` condition, shader.wgsl:485).

        `emit_info` (f32 lanes): the transport mode's scatter-history
        channel, refreshed to self._emit_fresh on every new camera ray.
        reference/unbiased: a may-emit flag (nonzero = the hit's emission
        may be added; reference mode ignores it). mis: the solid-angle pdf
        of the previous scatter's continuous part, or -1 for a delta
        history (camera ray / mirror chain).

        Returns (state, o', d', att', acc', alive', rays', emit_info')
        where alive' excludes lanes that missed (sky added) or were
        RR-killed this bounce. Depth termination is the caller's loop
        bound.
        """
        zeros = jnp.zeros_like(o.x)
        hit = self.prims.closest_hit(o, d, geom.RAY_EPS, geom.T_FAR,
                                     mask=alive)
        rays = rays + jnp.where(alive, 1.0, 0.0)

        if self.has_checker:
            # World-space 3-D checkerboard: odd-parity cells take the
            # alternate color. checker_scale == 0 marks untextured lanes
            # (the numeric encoding of models/scene.py to_arrays). The
            # recolor lands before NEE and the scatter, so both consume
            # the textured albedo — exactly as if the scene had a
            # primitive of that color there.
            #
            # KNIFE-EDGE caveat: floor() makes cell parity discontinuous,
            # so a 1-ulp cross-backend difference in the hit position
            # (FMA-contraction luck in o + d*t) can flip an isolated
            # boundary pixel's color between the oracle and the Pallas
            # kernel (observed: 1/1024 px on CPU interpret). Ray counts
            # and budgets stay exact below the Russian-roulette start
            # depth (color feeds RR only from bounce 4); the checker
            # tests pin depth <= 4 for exactly that reason.
            #
            # The +0.5 lattice offset keeps INTEGER-COORDINATE geometry
            # (the natural "floor plane at y=-1, scale 1" setup) in the
            # MIDDLE of a cell instead of exactly on a boundary — without
            # it, such a surface's p*k is an integer everywhere and its
            # whole area becomes FP-noise-dependent parity (measured:
            # ~2.75% of secondary hits flip), not an isolated edge.
            k = hit.checker_scale
            cells = (jnp.floor(hit.p.x * k + 0.5)
                     + jnp.floor(hit.p.y * k + 0.5)
                     + jnp.floor(hit.p.z * k + 0.5))
            odd = (cells - 2.0 * jnp.floor(cells * 0.5)) > 0.5
            hit = hit._replace(color=vm.where(
                (k > 0.0) & odd, hit.checker_color, hit.color
            ))

        if self.has_texture:
            # Image-texture recolor (extension): texels REPLACE the albedo
            # on textured lanes — after the checker, so a material with
            # both sees the texture win. Same before-NEE/scatter placement
            # and knife-edge caveat as the checker (see _texture_recolor).
            hit = self._texture_recolor(hit)

        if self.has_normal_map:
            # Normal-map perturbation (extension): the shading normal
            # bends per texel BEFORE NEE and the scatter consume it. After
            # the recolor (whose uv must come from the geometric normal,
            # matching how the maps are authored).
            hit = self._apply_normal_map(hit)

        scatter = None
        if self.has_fog:
            # Volume scattering (extension): sample the scatter distance
            # analytically — t = -ln(1-u)/sigma importance-samples the
            # transmittance exactly, so the path throughput needs NO
            # explicit exp() factor (see __init__ note). A draw shorter
            # than the surface hit turns this bounce into a scattering
            # event: isotropic redirection at sp, att *= fog albedo,
            # direct light from the volume point (below). One gated draw
            # for every live lane.
            state, u_d = prng.next_f32(state, alive)
            t_scat = jnp.log(jnp.maximum(1.0 - u_d, 1e-12)) * (
                -1.0 / self.fog_sigma
            )
            t_limit = jnp.where(hit.found, hit.t, geom.T_FAR)
            scatter = alive & (t_scat < t_limit)
            sp = o + d * t_scat

        # Miss -> sky contribution, then the lane dies (wgsl:447-452).
        # (Under fog the sky is reachable only if the distance draw
        # overshoots T_FAR — numerically never for real densities: an
        # infinite homogeneous medium hides the sky, as physics says.)
        miss_now = alive & (~hit.found)
        live = alive & hit.found
        if scatter is not None:
            miss_now = miss_now & (~scatter)
            live = live & (~scatter)
        # Environment-map sky (extension): miss radiance comes from the
        # sky texture sampled by ray direction instead of the gradient.
        # The sky is never NEE-sampled (reference semantics — NEE targets
        # emissive primitives only), so every transport adds it at full
        # attenuation, exactly like the gradient.
        sky = self._sky_radiance(d) if self.has_sky else sky_color(d)
        acc = acc + vm.where(miss_now, sky * att, vm.splat(zeros))

        # Emission on direct hit (wgsl:455) — every bounce, unweighted, in
        # reference mode; NEE-aware gating in unbiased mode; balance-
        # heuristic weighted in mis mode.
        if self.transport == "mis":
            # Competing NEE pdf for the point this BSDF ray hit: the area
            # pdf 1/area converted to solid angle, t^2 / (cos_l * area);
            # zero when the hit is not an NEE-sampled light (emissive
            # planes keep weight 1 — NEE never samples them).
            cos_l = jnp.maximum(vm.dot(hit.normal, -d), 0.0)
            p_nee = (hit.t * hit.t) * hit.light_inv_area / jnp.maximum(
                cos_l, 1e-8
            )
            if self.one_light:
                # Single-light NEE (extension): the NEE strategy's density
                # for the point this BSDF ray hit additionally carries the
                # probability of PICKING that light — the mirror image of
                # _one_light_nee's p_l = p_pick * t^2/(cos_l * area).
                if self.light_mode == "uniform":
                    p_nee = p_nee * (1.0 / self.n_lights)
                else:
                    # power: p_pick = lum * area / P_total; the hit's area
                    # term cancels against light_inv_area, leaving
                    # t^2 * lum / (P_total * cos_l), gated on the hit
                    # being an NEE-sampled light at all (lia > 0 — the
                    # same marker the emit gates use).
                    lights_now = (
                        [_Light(*l) for l in self.prims.light_list()]
                        if self.dynamic else self.lights
                    )
                    _pr, _cu, inv_total = self._light_pick(lights_now)
                    lum = (_LUM[0] * hit.emission.x
                           + _LUM[1] * hit.emission.y
                           + _LUM[2] * hit.emission.z)
                    p_nee = jnp.where(
                        hit.light_inv_area > 0.0,
                        (hit.t * hit.t) * lum * inv_total
                        / jnp.maximum(cos_l, 1e-8),
                        0.0,
                    )
            p_prev = jnp.maximum(emit_info, 0.0)
            if self.has_fog:
                # In a medium the previous scatter's BSDF/phase strategy
                # reaches this emitter only if its distance draw overshoots
                # the hit: its density carries exp(-sigma t) (see
                # direct_light's mirror-image factor on p_b).
                p_prev = p_prev * jnp.exp(-self.fog_sigma * hit.t)
            denom = p_prev + p_nee
            w_emit = jnp.where(
                emit_info < 0.0,
                1.0,
                p_prev / jnp.where(denom > 0.0, denom, 1.0),
            )
            acc = acc + vm.where(
                live, hit.emission * (att * w_emit), vm.splat(zeros)
            )
        else:
            # unbiased: emission is added iff NEE could NOT have sampled
            # this emitter from the previous vertex — a delta scatter
            # history (emit_info != 0), or an emitter NEE never samples
            # at all: hit.light_inv_area == 0 marks planes, back faces,
            # and sub-threshold emitters (the same mechanism the mis
            # branch uses above). Without the lia term, plane lights and
            # inside-an-emitter views went dark after any diffuse or
            # volume scatter — an under-count, not "unbiased".
            emit_gate = (
                (live & ((emit_info != 0.0)
                         | (hit.light_inv_area == 0.0)))
                if self.unbiased else live
            )
            acc = acc + vm.where(emit_gate, hit.emission * att,
                                 vm.splat(zeros))

        # NEE (wgsl:458-459). Shadow sweeps count as rays for live lanes.
        # The MIS transport's balance weight needs the delta-branch
        # selection probability — mirror plus (extension) glass: both are
        # delta-distributed, so NEE competes only with the diffuse lobe.
        nee_refl = hit.reflectivity
        if self.has_glass:
            nee_refl = nee_refl + hit.transparency
        rough_mis = None
        if self.has_rough and self.transport == "mis":
            # Under 'mis' the metal fuzz lobe is CONTINUOUS (analytic pdf
            # about the perfect mirror axis, sampling.fuzz_pdf): NEE also
            # estimates the metal lobe and both weight sites use the full
            # mixture density. The axis must be the PRE-fuzz mirror
            # direction — hoisted here (and reused by the scatter below)
            # so NEE can evaluate the lobe toward each sampled light.
            mirror_dir = vm.reflect(d, hit.normal)
            rough_mis = (hit.roughness, hit.reflectivity, mirror_dir)
        nee_gate = live if scatter is None else (live | scatter)
        state, direct = self.direct_light(
            state, hit.p, hit.normal, hit.color, att, nee_gate,
            refl=nee_refl,
            fog=None if scatter is None else (scatter, sp, d),
            rough=rough_mis,
        )
        if self.has_glass and self.transport != "mis":
            # The reference's NEE evaluates a full Lambertian lobe on
            # every surface; on mirrors that quirk is kept for parity
            # (PARITY.md). Glass has no reference counterpart to be
            # parity with, so scale NEE by the non-glass selection
            # probability — clear glass gets no matte direct-light ghost.
            # ('mis' already weighs NEE by the full diffuse-only
            # probability inside direct_light.) Volume scatter points use
            # the phase function, not the surface material: no scaling.
            ghost = 1.0 - hit.transparency
            if scatter is not None:
                ghost = jnp.where(scatter, 1.0, ghost)
            direct = direct * ghost
        acc = acc + vm.where(nee_gate, direct, vm.splat(zeros))
        rays = rays + jnp.where(nee_gate, float(self.nee_sweeps), 0.0)

        # Scatter: stochastic mirror-vs-diffuse (wgsl:465-480), with the
        # (extension) dielectric branch spliced into the same single
        # branch-selection draw: r < refl -> mirror; refl <= r <
        # refl + transparency -> glass (Fresnel-weighted reflect-or-
        # refract); else diffuse. transparency == 0 everywhere makes the
        # glass branch statically absent — reference-exact draws and ops.
        state, r_spec = prng.next_f32(state, live)
        is_refl = hit.reflectivity > r_spec
        refl_dir = (mirror_dir if rough_mis is not None
                    else vm.reflect(d, hit.normal))
        absorbed = None
        if self.has_rough:
            # Metal roughness (extension): fuzz the mirror branch —
            # reflect + roughness * uniform-sphere vector, re-normalized;
            # a fuzzed direction at/below the surface absorbs the path
            # (the standard fuzzy-metal semantics; the reference's dead
            # random_in_unit_sphere, shader.wgsl:117-124, gestures at
            # this). Two extra gated draws; roughness == 0 everywhere
            # compiles this block out (reference-exact program).
            fuzzy = hit.roughness > 0.0
            state, fz = sampling.uniform_sphere_dir(
                state, live & is_refl & fuzzy
            )
            raw = refl_dir + fz * hit.roughness
            len2 = vm.dot(raw, raw)
            inv_len = jax.lax.rsqrt(jnp.maximum(len2, 1e-12))
            fuzzed = raw * inv_len
            below = vm.dot(fuzzed, hit.normal) <= 0.0
            degen = len2 < 1e-12
            absorbed = live & is_refl & fuzzy & (below | degen)
            # Mirror branch only: the glass branch's TIR/Fresnel
            # reflection stays a perfect mirror (roughness is the METAL
            # lobe's parameter).
            refl_dir = vm.where(fuzzy & is_refl, fuzzed, refl_dir)
        if self.has_glass:
            # nee_refl IS reflectivity + transparency — reusing it keeps
            # the branch selection and the MIS weight provably consistent.
            is_glass = (~is_refl) & (nee_refl > r_spec)
            # hit.ior is only meaningful where transparency > 0 (the baked
            # sweep zeros it elsewhere); select a safe 1.0 first so masked
            # lanes never divide by zero.
            ior = jnp.where(hit.transparency > 0.0, hit.ior, 1.0)
            eta = jnp.where(hit.front, 1.0 / ior, ior)
            t_dir, cos_i, cos_t, tir = refract(d, hit.normal, eta)
            # Schlick's (1 - cos)^5 term must use the cosine on the LESS
            # dense side: the incident cosine when entering (eta < 1), the
            # transmitted cosine when exiting a denser medium (eta > 1) —
            # otherwise internal reflectance is ~6x underestimated just
            # below the critical angle and jumps discontinuously to 1 at
            # TIR. cos_t -> 0 at the critical angle makes this continuous.
            fres = fresnel_schlick(jnp.where(eta > 1.0, cos_t, cos_i), eta)
            # One extra gated draw: the Fresnel reflect-or-refract choice.
            state, r_fr = prng.next_f32(state, live & is_glass)
            glass_reflects = tir | (fres > r_fr)
            glass_dir = vm.where(glass_reflects, refl_dir, t_dir)
        else:
            is_glass = None
        diffuse_gate = (
            live & (~is_refl) if is_glass is None
            else live & (~is_refl) & (~is_glass)
        )
        state, cos_dir = sampling.cosine_hemisphere(
            state, hit.normal, diffuse_gate
        )
        new_d = vm.where(is_refl, refl_dir, cos_dir)
        if is_glass is not None:
            new_d = vm.where(is_glass, glass_dir, new_d)
        att = vm.where(live, att * hit.color, att)
        new_o = hit.p + new_d * geom.RAY_EPS  # offset along scatter dir (wgsl:482)
        if scatter is not None:
            # Volume scatter: phase-sampled redirection at the sampled
            # point; throughput picks up the single-scattering albedo
            # only (transmittance AND the phase are importance-sampled
            # away). g == 0 keeps the pre-anisotropy draws bit-exact.
            if self.fog_g != 0.0:
                state, fog_dir = sampling.henyey_greenstein_dir(
                    state, d, self.fog_g, scatter
                )
            else:
                state, fog_dir = sampling.uniform_sphere_dir(state, scatter)
            new_d = vm.where(scatter, fog_dir, new_d)
            new_o = vm.where(scatter, sp + fog_dir * geom.RAY_EPS, new_o)
            att = vm.where(scatter, att * V3(*self.fog_albedo), att)
            if self.transport == "mis":
                # The phase lobe's solid-angle pdf for the continuation —
                # the mis emit-info channel of a volume scatter (`d` is
                # still the incoming direction here).
                ph_cont = sampling.hg_phase(vm.dot(d, fog_dir), self.fog_g)

        # Russian roulette from bounce 4 (wgsl:485-492): kill first,
        # compensate survivors. Volume scatter events face the same RR
        # (their att already carries the fog albedo).
        cont = live if scatter is None else (live | scatter)
        rr_on = cont & (bounce_idx > RR_START_BOUNCE)
        state, r_rr = prng.next_f32(state, rr_on)
        p_surv = jnp.minimum(RR_MAX_SURVIVAL, vm.max_component(att))
        # p_surv == 0 (att exactly black — e.g. pure-absorption fog, or a
        # color-(0,0,0) surface) kills unconditionally: the reference's
        # literal `rand > p` check would let the measure-zero rand == 0.0
        # draw survive into an att/0 = NaN that poisons the accumulator
        # forever (the reference shares the hazard); a black path
        # contributes nothing either way, so the decisive kill is the
        # only output-visible-safe choice.
        killed = rr_on & ((p_surv < r_rr) | (p_surv <= 0.0))
        att = vm.where(rr_on & ~killed, att / p_surv, att)
        alive = cont & (~killed)
        if absorbed is not None:
            # Fuzzed-below-surface metal scatter: the path is absorbed
            # (this bounce's emission/NEE stand; no sky, no continuation).
            alive = alive & (~absorbed)

        # Sanitize dead lanes so NaNs can't leak into the next sweep.
        d = vm.where(alive, new_d, V3(zeros, zeros, zeros + 1.0))
        o = vm.where(alive, new_o, vm.splat(zeros))
        # Next bounce's scatter history: mirror/glass = delta; diffuse =
        # the continuous-part pdf (mis) / emission disallowed (unbiased).
        is_delta = is_refl if is_glass is None else (is_refl | is_glass)
        if self.transport == "mis":
            cos_new = jnp.maximum(vm.dot(hit.normal, new_d), 0.0)
            p_cont = (1.0 - nee_refl) * cos_new * (1.0 / sampling.PI)
            if rough_mis is not None:
                # Fuzzy mirror scatters are continuous: drop them from
                # the delta set and extend the mixture pdf with the metal
                # lobe's density at the chosen direction (the same
                # guarded fuzz_pdf direct_light competes with — an exact
                # partition of unity between the two weight sites).
                is_delta = is_delta & ~(is_refl & fuzzy)
                p_cont = p_cont + hit.reflectivity * sampling.fuzz_pdf(
                    vm.dot(mirror_dir, new_d), hit.roughness
                )
            emit_info = jnp.where(is_delta, -1.0, p_cont)
            if scatter is not None:
                # A volume scatter is a continuous (phase-sampled) event:
                # the next hit's emission competes against NEE-from-the-
                # scatter-point at the phase pdf.
                emit_info = jnp.where(scatter, ph_cont, emit_info)
        else:
            emit_info = jnp.where(is_delta, 1.0, 0.0)
            if scatter is not None:
                # A volume scatter is a continuous (phase-sampled) event:
                # like a diffuse surface scatter, unbiased mode gates the
                # next hit's emission to NEE-unreachable emitters only
                # (the lia term in the emit gate above keeps plane lights
                # and back faces visible through fog).
                emit_info = jnp.where(scatter, 0.0, emit_info)
        return state, o, d, att, acc, alive, rays, emit_info

    # ------------------------------------------------------------------
    # ray_color: the masked wavefront bounce loop (shader.wgsl:439-495)
    # ------------------------------------------------------------------

    def ray_color(self, state, o: V3, d: V3, gate=None, with_iters=False):
        """Trace one path per lane. Returns (state', color V3, rays).

        `rays` counts hit_scene traversals per lane (primary/bounce sweeps
        plus NEE shadow sweeps) — the unit of the Mray/s benchmark metric.
        `gate` (bool lanes) marks lanes whose reference thread runs this
        trace at all (the adaptive extra-sample loop); gated-off lanes never
        draw RNG and contribute nothing.

        with_iters=True appends the EXECUTED bounce-loop trip count (i32
        scalar — the loop is lockstep, so one number covers every lane):
        the denominator unit of the oracle's measured occupancy
        (render_frame with_occ). The flag only re-exposes the loop's own
        counter — the traced program is unchanged.
        """
        lanes = o.x
        zeros = jnp.zeros_like(lanes)
        alive0 = jnp.ones_like(lanes, dtype=bool) if gate is None else gate
        # The alive mask is carried as f32, not bool (ROADMAP D2).
        init = (
            jnp.zeros((), jnp.int32),  # bounce index
            state,
            o,
            d,
            vm.splat(jnp.ones_like(lanes)),  # attenuation
            vm.splat(zeros),  # accumulated color
            jnp.where(alive0, 1.0, 0.0),  # alive mask (f32 carry)
            zeros,  # ray counter
            zeros + self._emit_fresh,  # emit-info channel (f32 carry)
        )

        def cond(carry):
            i, _, _, _, _, _, alive_f, _, _ = carry
            return (i < self.max_depth) & jnp.any(alive_f != 0.0)

        def body(carry):
            i, state, o, d, att, acc, alive_f, rays, emit_f = carry
            state, o, d, att, acc, alive, rays, emit_f = self.bounce_step(
                state, o, d, att, acc, alive_f != 0.0, i, rays, emit_f
            )
            return (i + 1, state, o, d, att, acc, jnp.where(alive, 1.0, 0.0),
                    rays, emit_f)

        out = jax.lax.while_loop(cond, body, init)
        iters, state, _, _, _, acc, _, rays, _ = out
        if with_iters:
            return state, acc, rays, iters
        return state, acc, rays

    # ------------------------------------------------------------------
    # Camera ray generation (shader.wgsl:519-546)
    # ------------------------------------------------------------------

    def stratify_jitter(self, samp, rx, ry):
        """Remap a BASE-phase sample's uniform sub-pixel jitter (rx, ry in
        [0, 1)) into cell ``samp mod g^2`` of the g x g stratification
        grid (models/scene.py `sampler`; g^2 divides the base count — see
        __init__). Pure affine remap of the SAME two draws — RNG chains,
        draw counts and gates are untouched, so every scheduler/backend
        derives identical jitter from identical state. ``samp`` is the
        pixel's absolute sample index (scalar loop index or per-lane i32
        vector — the bit ops below work on both);
        indices >= base (adaptive extras) keep the raw jitter. Identity
        when strat_g == 1 (static)."""
        g = self.strat_g
        if g <= 1:
            return rx, ry
        s = jnp.asarray(samp, jnp.int32)
        in_base = s < self.base_samples
        cx = jnp.bitwise_and(s, g - 1).astype(jnp.float32)
        cy = jnp.bitwise_and(
            jax.lax.shift_right_logical(s, g.bit_length() - 1), g - 1
        ).astype(jnp.float32)
        inv_g = 1.0 / float(g)
        return (jnp.where(in_base, (cx + rx) * inv_g, rx),
                jnp.where(in_base, (cy + ry) * inv_g, ry))

    def gen_ray(self, state, cam: Cam, xf, yf, gate=None, samp=0):
        """One camera ray per lane (shader.wgsl:519-546): two jitter draws,
        NDC with the char-aspect vertical squash, then the camera basis.
        ``samp`` (absolute per-pixel sample index; scalar or lane vector)
        only matters to the stratified sampler's jitter remap — the
        'reference' sampler (strat_g == 1) ignores it statically."""
        state, rx = prng.next_f32(state, gate)
        state, ry = prng.next_f32(state, gate)
        rx, ry = self.stratify_jitter(samp, rx, ry)
        u = (xf + rx) / float(self.width - 1)
        v = ((self.height - 1) - yf + ry) / float(self.height - 1)
        ndc_x = 2.0 * u - 1.0
        ndc_y = (2.0 * v - 1.0) * self.inv_char_aspect
        vx = self.half_width * ndc_x
        vy = self.half_height * ndc_y
        d = vm.normalize(cam.right * vx + cam.up * vy + cam.forward)
        o = vm.splat(jnp.zeros_like(d.x)) + cam.pos
        if self.aperture > 0.0:
            # Thin lens: the pinhole ray fixes the focal point (where it
            # pierces the plane at focus_distance along forward); the real
            # ray starts from a uniform sample of the lens disk and aims
            # there. Two extra draws per primary ray, statically absent at
            # aperture == 0.
            state, r1, r2 = prng.next_f32_pair(state, gate)
            lr = self.aperture * jnp.sqrt(r1)
            phi = sampling.TWO_PI * r2
            t_focus = self.focus_distance / vm.dot(d, cam.forward)
            p_focus = o + d * t_focus
            o = o + cam.right * (lr * jnp.cos(phi)) + cam.up * (
                lr * jnp.sin(phi)
            )
            d = vm.normalize(p_focus - o)
        return state, o, d

    # ------------------------------------------------------------------
    # Per-pixel sample loops + adaptive sampling (shader.wgsl:499-602)
    # ------------------------------------------------------------------

    def render_lanes(self, cam: Cam, x, y, seed, frame_number, active=None,
                     with_cap=False):
        """Render a lane grid of pixels.

        x, y: integer pixel coordinate arrays of the lane shape.
        `active` (bool lanes, optional) marks lanes that correspond to real
        pixels — the kernel's last block carries out-of-bounds lanes that
        must not trace or count rays.
        Returns (current_sample V3, variance, total_samples, rays) per lane,
        where current_sample is already divided per the reference's
        (quirky) normalization — ready for temporal accumulation.

        with_cap=True appends the EXECUTED bounce-iteration total (i32
        scalar, summed over every sample/chunk loop) — the lockstep sweep
        capacity behind the oracle's measured occupancy: each executed
        iteration runs 1 closest-hit + n_lights shadow sweeps on every
        lane, owed or not. False (the default) threads nothing extra — the
        traced program is bit-identical to the pre-flag code.
        """
        xf = x.astype(jnp.float32)
        yf = y.astype(jnp.float32)
        pix = y.astype(jnp.uint32) * jnp.uint32(self.width) + x.astype(jnp.uint32)
        state0 = prng.seed_pixel(pix, jnp.asarray(seed), jnp.asarray(frame_number))

        zeros = jnp.zeros_like(xf)
        base = self.base_samples
        spp = self.spp

        cap = jnp.zeros((), jnp.int32)

        def sample_body(i, carry):
            if with_cap:
                state, csum, csumsq, rays, cp = carry
            else:
                state, csum, csumsq, rays = carry
            state = prng.advance_sample(state, i)
            state, o, d = self.gen_ray(state, cam, xf, yf, samp=i)
            if with_cap:
                state, c, r, it = self.ray_color(state, o, d, active,
                                                 with_iters=True)
                return (state, csum + c, csumsq + c * c, rays + r, cp + it)
            state, c, r = self.ray_color(state, o, d, active)
            return (state, csum + c, csumsq + c * c, rays + r)

        if self.chunk_base is None:
            init_b = (state0, vm.splat(zeros), vm.splat(zeros), zeros)
            if with_cap:
                state, csum, csumsq, rays, cap = jax.lax.fori_loop(
                    0, base, sample_body, init_b + (cap,)
                )
            else:
                state, csum, csumsq, rays = jax.lax.fori_loop(
                    0, base, sample_body, init_b
                )
        else:
            # Chunk-split base phase — the ORACLE side of the sub-chain
            # derivation (see CHUNK_GOLDEN): chunk c seeds
            # state0 + c*GOLDEN (c = 0: state0 itself), samples keep their
            # absolute indices, sums accumulate in chunk order (the same
            # f32 addition order render_lanes_regen uses), and the extra
            # phase continues chunk 0's end state.
            cb = self.chunk_base
            csum, csumsq, rays = vm.splat(zeros), vm.splat(zeros), zeros
            state = state0
            for c in range(-(-base // cb)):
                share = min(cb, base - c * cb)
                st_c = (state0 if c == 0 else
                        state0 + jnp.uint32(c) * jnp.uint32(CHUNK_GOLDEN))

                def chunk_body(j, carry, _c=c):
                    if with_cap:
                        st, cs, cq, ry, cp = carry
                    else:
                        st, cs, cq, ry = carry
                    st = prng.advance_sample(st, _c * cb + j)
                    st, o, d = self.gen_ray(st, cam, xf, yf, samp=_c * cb + j)
                    if with_cap:
                        st, col, r, it = self.ray_color(st, o, d, active,
                                                        with_iters=True)
                        return (st, cs + col, cq + col * col, ry + r,
                                cp + it)
                    st, col, r = self.ray_color(st, o, d, active)
                    return (st, cs + col, cq + col * col, ry + r)

                init_cb = (st_c, vm.splat(zeros), vm.splat(zeros), zeros)
                if with_cap:
                    st_c, cs, cq, ry, cap = jax.lax.fori_loop(
                        0, share, chunk_body, init_cb + (cap,)
                    )
                else:
                    st_c, cs, cq, ry = jax.lax.fori_loop(
                        0, share, chunk_body, init_cb
                    )
                csum, csumsq, rays = csum + cs, csumsq + cq, rays + ry
                if c == 0:
                    state = st_c

        # Variance of the base samples, per wgsl:555-558 (sum of per-channel
        # E[x^2] - E[x]^2; can be slightly negative in f32, kept raw).
        mean = csum * (1.0 / base)
        var = vm.sum_components(csumsq * (1.0 / base) - mean * mean)

        if base >= spp:
            # Adaptive branch statically dead (wgsl:561 needs base < spp).
            # Reference still divides the base-sample sum by spp — the
            # spp < 4 brightening quirk.
            current = csum * (1.0 / spp)
            total = zeros + float(base)
            if with_cap:
                return current, var, total, rays, cap
            return current, var, total, rays

        # Per-pixel extra-sample budget (wgsl:561-562): f32 compare avoids
        # the u32 overflow the reference risks on huge variance.
        needs = var > ADAPTIVE_VAR_THRESHOLD
        if active is not None:
            needs = needs & active
        additional = jnp.where(
            needs,
            jnp.minimum(float(spp - base), jnp.floor(var * ADAPTIVE_VAR_SCALE)),
            0.0,
        )

        def extra_cond(carry):
            j, *_ = carry
            return (j < (spp - base)) & jnp.any(j.astype(jnp.float32) < additional)

        def extra_body(carry):
            if with_cap:
                j, state, esum, rays, cp = carry
            else:
                j, state, esum, rays = carry
            take = j.astype(jnp.float32) < additional
            state = prng.advance_sample(state, base + j, take)
            state, o, d = self.gen_ray(state, cam, xf, yf, take, samp=base + j)
            if with_cap:
                state, c, r, it = self.ray_color(state, o, d, take,
                                                 with_iters=True)
            else:
                state, c, r = self.ray_color(state, o, d, take)
            esum = esum + vm.where(take, c, vm.splat(zeros))
            rays = rays + jnp.where(take, r, 0.0)
            if with_cap:
                return (j + 1, state, esum, rays, cp + it)
            return (j + 1, state, esum, rays)

        if self.chunk_extra is not None:
            # Chunk-split extra phase, oracle side (see CHUNK_GOLDEN): the
            # budget slices, sub-chain seeds, and absolute sample indices
            # mirror render_lanes_regen exactly; per-pixel esum
            # accumulates in chunk order.
            ce = self.chunk_extra
            esum = vm.splat(zeros)
            for c in range(-(-(spp - base) // ce)):
                budget_c = jnp.clip(additional - float(c * ce), 0.0,
                                    float(ce))
                st_c = (state if c == 0 else
                        state + jnp.uint32(c) * jnp.uint32(CHUNK_GOLDEN))
                s0 = base + c * ce

                def chunk_cond(carry, _b=budget_c):
                    j, *_ = carry
                    return (j < ce) & jnp.any(j.astype(jnp.float32) < _b)

                def chunk_extra_body(carry, _b=budget_c, _s0=s0):
                    if with_cap:
                        j, st, es, ry, cp = carry
                    else:
                        j, st, es, ry = carry
                    take = j.astype(jnp.float32) < _b
                    st = prng.advance_sample(st, _s0 + j, take)
                    st, o, d = self.gen_ray(st, cam, xf, yf, take,
                                            samp=_s0 + j)
                    if with_cap:
                        st, col, r, it = self.ray_color(st, o, d, take,
                                                        with_iters=True)
                    else:
                        st, col, r = self.ray_color(st, o, d, take)
                    es = es + vm.where(take, col, vm.splat(zeros))
                    ry = ry + jnp.where(take, r, 0.0)
                    if with_cap:
                        return (j + 1, st, es, ry, cp + it)
                    return (j + 1, st, es, ry)

                init_c = (jnp.zeros((), jnp.int32), st_c, vm.splat(zeros),
                          zeros)
                if with_cap:
                    init_c = init_c + (cap,)
                out_c = jax.lax.while_loop(chunk_cond, chunk_extra_body,
                                           init_c)
                if with_cap:
                    _, _, es_c, ry_c, cap = out_c
                else:
                    _, _, es_c, ry_c = out_c
                esum = esum + es_c
                rays = rays + ry_c
        else:
            extra_init = (jnp.zeros((), jnp.int32), state, vm.splat(zeros),
                          rays)
            if with_cap:
                extra_init = extra_init + (cap,)
            out_e = jax.lax.while_loop(extra_cond, extra_body, extra_init)
            if with_cap:
                _, state, esum, rays, cap = out_e
            else:
                _, state, esum, rays = out_e

        # Normalization (wgsl:600-610): adaptive pixels average over the
        # samples actually taken; everyone else divides base sum by spp.
        total = float(base) + additional
        current = vm.where(
            needs,
            (csum + esum) * (1.0 / total),
            csum * (1.0 / spp),
        )
        if with_cap:
            return current, var, total, rays, cap
        return current, var, total, rays

    # ------------------------------------------------------------------
    # Path regeneration (the high-occupancy wavefront scheduler)
    # ------------------------------------------------------------------
    #
    # The lockstep sample loop above executes max_depth bounce steps per
    # sample for EVERY lane; after Russian roulette / misses most lanes are
    # dead ballast (~30% occupancy at depth 32). Path regeneration fixes
    # this: each lane works through its own sample quota at its own pace —
    # the moment a lane's path terminates, the next iteration regenerates a
    # fresh camera ray for that lane's next sample. One phase runs for
    # ~quota x E[path length] iterations instead of quota x max_depth, and
    # the adaptive extra-sample phase costs each lane only what its own
    # variance budget demands (shader.wgsl:561-562) rather than the tile
    # maximum. Per-lane RNG chains are identical to the lockstep driver
    # (every draw carries the same reference-control-flow gate), so results
    # are bit-equal — this is purely a scheduler change.

    def regen_carry0(self, cam: Cam, xf, yf, state, quota):
        zeros = jnp.zeros_like(xf)
        return (
            state,  # u32 rng
            jnp.zeros_like(xf, dtype=jnp.int32),  # sample index
            quota,  # f32 per-lane sample quota
            vm.splat(zeros),  # o
            V3(zeros, zeros, zeros + 1.0),  # d (unit placeholder)
            vm.splat(zeros),  # att (dead until regenerated)
            vm.splat(zeros),  # acc of the in-flight sample
            jnp.zeros_like(xf, dtype=jnp.int32),  # bounce counter
            zeros,  # alive (f32 mask)
            vm.splat(zeros),  # csum
            vm.splat(zeros),  # csumsq
            zeros,  # rays
            zeros,  # emission-allowed mask (f32; refreshed at regen)
        )

    def regen_pending(self, carry):
        """Scalar count of lanes still owing work (drives the while cond)."""
        samp, quota, alive_f = carry[1], carry[2], carry[8]
        pending = (alive_f != 0.0) | (samp.astype(jnp.float32) < quota)
        return jnp.sum(jnp.where(pending, 1, 0)).astype(jnp.int32)

    def regen_step(self, cam: Cam, xf, yf, carry):
        """One scheduler iteration: regenerate finished lanes, advance every
        live lane one bounce, fold finished samples into the accumulators.
        Returns the updated carry."""
        (state, samp, quota, o, d, att, acc, bounce, alive_f, csum, csumsq,
         rays, emit_f) = carry
        zeros = jnp.zeros_like(xf)
        alive = alive_f != 0.0

        # Regenerate: idle lanes with samples remaining start their next
        # sample (same draws the lockstep sample loop would make:
        # per-sample re-hash, then 2 ray-gen draws — shader.wgsl:517-520).
        need = (~alive) & (samp.astype(jnp.float32) < quota)
        state = prng.advance_sample(state, samp, need)
        state, o2, d2 = self.gen_ray(state, cam, xf, yf, need, samp=samp)
        o = vm.where(need, o2, o)
        d = vm.where(need, d2, d)
        att = vm.where(need, vm.splat(jnp.ones_like(xf)), att)
        acc = vm.where(need, vm.splat(zeros), acc)
        bounce = jnp.where(need, 0, bounce)
        alive = alive | need
        emit_f = jnp.where(need, self._emit_fresh, emit_f)  # fresh camera ray

        # One bounce for all live lanes.
        executed = alive
        state, o, d, att, acc, alive, rays, emit_f = self.bounce_step(
            state, o, d, att, acc, alive, bounce, rays, emit_f
        )

        # Termination bookkeeping: miss/RR-kill (alive dropped) or depth
        # exhausted (the reference loop simply ends, shader.wgsl:444).
        bounce = jnp.where(executed, bounce + 1, bounce)
        at_depth = alive & (bounce >= self.max_depth)
        finished = (executed & (~alive)) | at_depth
        csum = csum + vm.where(finished, acc, vm.splat(zeros))
        csumsq = csumsq + vm.where(finished, acc * acc, vm.splat(zeros))
        samp = samp + jnp.where(finished, 1, 0)
        alive = alive & (~at_depth)

        return (state, samp, quota, o, d, att, acc, bounce,
                jnp.where(alive, 1.0, 0.0), csum, csumsq, rays, emit_f)

    def _run_regen_jnp(self, cam, xf, yf, carry):
        """XLA driver: vector-carry while loop (oracle / CPU / tests)."""
        # Safety bound only — the pending count is the real exit condition.
        max_iters = (self.spp + 1) * self.max_depth + 4

        def cond(c):
            it, carry = c
            return (it < max_iters) & (self.regen_pending(carry) > 0)

        def body(c):
            it, carry = c
            return (it + 1, self.regen_step(cam, xf, yf, carry))

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
        return carry

    # The regeneration pipeline decomposes into three pieces so schedulers
    # can be composed around them — render_lanes_regen runs them in order;
    # the sample-split mesh path (parallel/mesh.py) merges the phases'
    # statistics across cards between them.

    def seed_lanes(self, x, y, seed, frame_number):
        pix = y.astype(jnp.uint32) * jnp.uint32(self.width) + x.astype(jnp.uint32)
        return prng.seed_pixel(pix, jnp.asarray(seed), jnp.asarray(frame_number))

    def base_phase(self, cam: Cam, xf, yf, state0, active, run, quota=None,
                   samp0=None):
        """Phase 1: `base` samples per (active) pixel. Returns
        (state_after, csum V3, csumsq V3, rays). `quota` (traced f32
        scalar, optional) overrides the static base quota — the
        unequal-share sample-split path (parallel/mesh.py). `samp0` (i32
        lanes, optional) offsets the starting sample index — the chunked
        base phase renders samples [samp0, samp0 + quota) of each pixel's
        (sub-chain) budget with absolute per-sample re-hash indices."""
        zeros = jnp.zeros_like(xf)
        quota1 = zeros + (
            float(self.base_samples) if quota is None else quota
        )
        if active is not None:
            quota1 = jnp.where(active, quota1, 0.0)
        carry0 = list(self.regen_carry0(cam, xf, yf, state0, quota1))
        if samp0 is not None:
            carry0[1] = samp0  # starting sample index
            carry0[2] = carry0[2] + samp0.astype(jnp.float32)  # abs quota
        carry = run(tuple(carry0))
        (state, _, _, _, _, _, _, _, _, csum, csumsq, rays, _) = carry
        return state, csum, csumsq, rays

    def variance_of(self, csum: V3, csumsq: V3):
        """Luminance-sum variance of the base samples (wgsl:555-558)."""
        base = self.base_samples
        mean = csum * (1.0 / base)
        return vm.sum_components(csumsq * (1.0 / base) - mean * mean)

    def extra_quota(self, var, active=None):
        """needs mask + per-pixel extra-sample budget (wgsl:561-562)."""
        needs = var > ADAPTIVE_VAR_THRESHOLD
        if active is not None:
            needs = needs & active
        additional = jnp.where(
            needs,
            jnp.minimum(
                float(self.spp - self.base_samples),
                jnp.floor(var * ADAPTIVE_VAR_SCALE),
            ),
            0.0,
        )
        return needs, additional

    def extra_phase(self, cam: Cam, xf, yf, state, additional, rays0, run,
                    samp0=None):
        """Phase 2: per-lane extra quota; sample indices continue at `base`
        so the per-sample re-hash matches shader.wgsl:565. `samp0` (i32
        lanes, default base) sets each lane's starting sample index — the
        chunk-split turbo pipeline hands each entry its own sub-range.
        Returns (esum V3, rays)."""
        base = self.base_samples
        if samp0 is None:
            samp0 = jnp.zeros_like(xf, dtype=jnp.int32) + base
        carry2 = list(self.regen_carry0(cam, xf, yf, state, additional))
        carry2[1] = samp0  # starting sample index
        carry2[2] = additional + samp0.astype(jnp.float32)  # absolute quota
        carry2[11] = rays0
        carry = run(tuple(carry2))
        (_, _, _, _, _, _, _, _, _, esum, _, rays, _) = carry
        return esum, rays

    def combine_phases(self, csum: V3, esum: V3, needs, additional):
        """The reference's normalization (wgsl:600-610): adaptive pixels
        average over samples actually taken; everyone else divides the base
        sum by spp. Returns (current V3, total_samples)."""
        base, spp = self.base_samples, self.spp
        total = float(base) + additional
        current = vm.where(
            needs,
            (csum + esum) * (1.0 / total),
            csum * (1.0 / spp),
        )
        return current, total

    def render_lanes_regen(self, cam: Cam, x, y, seed, frame_number,
                           active=None, driver=None):
        """render_lanes with the path-regeneration scheduler. Bit-identical
        outputs (same RNG chains); `driver(carry0) -> carry` overrides the
        loop driver (the GPU kernel supplies one that counts iterations)."""
        xf = x.astype(jnp.float32)
        yf = y.astype(jnp.float32)
        state0 = self.seed_lanes(x, y, seed, frame_number)
        zeros = jnp.zeros_like(xf)
        run = driver if driver is not None else (
            lambda c: self._run_regen_jnp(cam, xf, yf, c)
        )

        if self.chunk_base is None:
            state, csum, csumsq, rays = self.base_phase(cam, xf, yf, state0,
                                                        active, run)
        else:
            # Chunked base under the regen driver — same sub-chain
            # derivation as render_lanes, so both schedulers remain
            # decision-exact on chunked tracers.
            cb = self.chunk_base
            base = self.base_samples
            csum, csumsq, rays = vm.splat(zeros), vm.splat(zeros), zeros
            state = state0
            for c in range(-(-base // cb)):
                share = min(cb, base - c * cb)
                st_c = (state0 if c == 0 else
                        state0 + jnp.uint32(c) * jnp.uint32(CHUNK_GOLDEN))
                s0 = jnp.zeros_like(x, dtype=jnp.int32) + (c * cb)
                st_c, cs, cq, ry = self.base_phase(
                    cam, xf, yf, st_c, active, run, quota=float(share),
                    samp0=s0,
                )
                csum, csumsq, rays = csum + cs, csumsq + cq, rays + ry
                if c == 0:
                    state = st_c
        var = self.variance_of(csum, csumsq)

        if self.base_samples >= self.spp:
            current = csum * (1.0 / self.spp)
            total = zeros + float(self.base_samples)
            return current, var, total, rays

        needs, additional = self.extra_quota(var, active)
        if self.chunk_extra is None:
            esum, rays = self.extra_phase(cam, xf, yf, state, additional,
                                          rays, run)
        else:
            ce = self.chunk_extra
            base = self.base_samples
            esum = vm.splat(zeros)
            for c in range(-(-(self.spp - base) // ce)):
                budget_c = jnp.clip(additional - float(c * ce), 0.0,
                                    float(ce))
                st_c = (state if c == 0 else
                        state + jnp.uint32(c) * jnp.uint32(CHUNK_GOLDEN))
                s0 = jnp.zeros_like(x, dtype=jnp.int32) + (base + c * ce)
                es_c, rays = self.extra_phase(cam, xf, yf, st_c, budget_c,
                                              rays, run, samp0=s0)
                esum = esum + es_c
        current, total = self.combine_phases(csum, esum, needs, additional)
        return current, var, total, rays

    # ------------------------------------------------------------------
    # Whole-frame oracle entry point
    # ------------------------------------------------------------------

    def render_frame(self, pose, seed, frame_number, with_occ=False):
        """Render the full (H, W) image in one fused jax.numpy computation —
        the oracle renderer (and the CPU path). Returns
        (current V3[H,W], variance[H,W], total_samples[H,W], rays_total).

        with_occ=True appends the measured sweep-weighted lane occupancy
        — owed sweeps (rays) over executed lane-iteration sweeps, the
        SAME accounting the GPU kernel surfaces: each executed lockstep
        bounce iteration charges every lane 1 closest-hit + n_lights
        shadow sweeps, whether the lane owed them or not. The oracle's
        lockstep sample loops exit when every lane dies, so the capacity
        is measured — not the static spp x max_depth bound."""
        h, w = self.height, self.width
        y = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
        x = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
        cam = cam_from_pose(pose)
        if with_occ:
            current, var, total, rays, cap = self.render_lanes(
                cam, x, y, seed, frame_number, with_cap=True
            )
            rays_sum = jnp.sum(rays)
            sweeps = cap.astype(jnp.float32) * float(
                h * w * (1 + self.nee_sweeps)
            )
            occ = rays_sum / jnp.maximum(sweeps, 1.0)
            return current, var, total, rays_sum, occ
        current, var, total, rays = self.render_lanes(cam, x, y, seed, frame_number)
        return current, var, total, jnp.sum(rays)

    def render_frame_dynamic(self, pose, seed, frame_number, arrays,
                             with_occ=False):
        """render_frame for a dynamic=True tracer: `arrays` is the
        ops.dynamic.pack_scene mapping of traced geometry/material values
        — a runtime input, so animated scenes never retrace (the template
        scene fixes only counts and the light topology)."""
        assert self.dynamic
        self.prims.bind({k: jnp.asarray(v, jnp.float32)
                         for k, v in arrays.items()})
        return self.render_frame(pose, seed, frame_number, with_occ=with_occ)
