"""Array-resident scene traversal: fixed code size for ANY primitive count.

The default traversal bakes each primitive as unrolled compile-time
constants (ops/geometry.py) — unbeatable for the reference's shipped <= ~30
primitives, but code size, compile time, and per-lane sweep cost all grow
O(N) in *unrolled code*. The reference itself has no such wall: its kernel
reads primitives from a storage buffer (reference: src/lib.rs:301-305)
inside a data-dependent loop (src/shader.wgsl:248-294 `hit_scene`,
`primitive_count` in uniforms) — fixed kernel code for any N.

This module is the equivalent here: SoA value arrays (models/scene.py
`to_arrays` via ops/dynamic.pack_scene layout plus host-precomputed derived
quantities) swept by a `lax.fori_loop` whose body intersects ONE primitive
against every lane per iteration. Code size is O(1) in N; the data lives in
global memory inputs of the GPU kernel (scalar loads broadcast into the
vector intersection math — the analog of the reference's uniform
storage-buffer read per loop iteration) and as device constants in the jnp
oracle.

Bit parity: every per-primitive computation uses the same f32 values and
the same op order as the baked sweep — derived constants (sphere 1/r,
plane unit normals, triangle edges/normals/areas) are precomputed
host-side with geometry.ScenePrims' exact stepwise-f32 arithmetic, and the
loop applies the same strictly-closer overwrite chain (shader.wgsl:279).
An `accel='array'` render is bit-identical to `accel='baked'` on every
scene both can compile, up to one CPU-only caveat: XLA-CPU may contract
FMAs differently inside a fori_loop body than in the baked unrolled code,
a <= 1-ulp t divergence on general-position geometry (observed on mesh
scenes — see `_fori`). The packaged scenes and the sphere stress fields
are bit-exact in practice (tests/test_arrayscene); mesh scenes pin exact
ray counts + tight allclose (tests/test_mesh).

Lights/NEE stay baked: the scene is static, the light set is tiny, and
tracer.PathTracer builds its compile-time light list independently of the
traversal — only closest-hit and shadow (occluded) sweeps go through here.

Loop carries are f32 lane vectors; the winner's material/normal channels
ride the carry as masked selects — no per-lane gathers anywhere.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import scene as scene_mod
from . import geometry as geom
from . import vecmath as vm
from .vecmath import V3

# SoA layout (key -> per-kind count), geometry + derived + materials.
# Derived keys beyond ops/dynamic.pack_scene: s_invr (f32 1/radius,
# geometry.ScenePrims), p_u* (unit plane normal), t_e1*/t_e2*/t_u*
# (triangle edges / unit normal, geometry._tri_edges_f32), *_lia
# (1/area iff NEE light, else 0 — Hit.light_inv_area).
SPHERE_KEYS = ("s_cx", "s_cy", "s_cz", "s_r", "s_invr",
               "s_colr", "s_colg", "s_colb",
               "s_emir", "s_emig", "s_emib", "s_refl", "s_lia")
PLANE_KEYS = ("p_px", "p_py", "p_pz", "p_nx", "p_ny", "p_nz",
              "p_ux", "p_uy", "p_uz",
              "p_colr", "p_colg", "p_colb",
              "p_emir", "p_emig", "p_emib", "p_refl")
TRI_KEYS = ("t_ax", "t_ay", "t_az",
            "t_e1x", "t_e1y", "t_e1z", "t_e2x", "t_e2y", "t_e2z",
            "t_ux", "t_uy", "t_uz",
            "t_colr", "t_colg", "t_colb",
            "t_emir", "t_emig", "t_emib", "t_refl", "t_lia")

# Manual fori body unroll factor: amortizes the loop's scalar bookkeeping
# (and pipelines the scalar loads) over several per-primitive sweeps. Not
# measured on the H100 (ROADMAP S6). Tunable per-build via
# ArrayPrims(unroll=).
DEFAULT_UNROLL = 8


def pack_scene_soa(scene: scene_mod.Scene):
    """Scene -> {key: (count,) f32 ndarray} covering the layout above:
    ops.dynamic.pack_scene's geometry/material arrays (one extraction
    path, shared with the dynamic modes) plus the derived quantities,
    precomputed with the baked path's stepwise-f32 host math."""
    from . import dynamic as dyn_mod

    out = dict(dyn_mod.pack_scene(scene))

    out["s_invr"] = np.array(
        [np.float32(1.0) / np.float32(s.radius) for s in scene.spheres],
        np.float32,
    )
    out["s_lia"] = np.array(
        [1.0 / (4.0 * 3.14159265359 * float(s.radius) ** 2)
         if s.material.is_light else 0.0 for s in scene.spheres], np.float32
    )

    units = []
    for p in scene.planes:
        n = np.asarray(p.normal, np.float32)
        units.append(n / np.float32(np.sqrt(np.dot(n, n))))
    units = (np.stack(units) if scene.planes
             else np.zeros((0, 3), np.float32)).astype(np.float32)
    out["p_ux"], out["p_uy"], out["p_uz"] = units.T

    tris = scene.triangles
    e1s, e2s, uns, lias = [], [], [], []
    for t in tris:
        e1, e2, n_unit, area = geom._tri_edges_f32(t)
        e1s.append(e1)
        e2s.append(e2)
        uns.append(n_unit)
        lias.append(1.0 / area if t.material.is_light else 0.0)
    z03 = np.zeros((0, 3), np.float32)
    e1s = np.stack(e1s).astype(np.float32) if tris else z03
    e2s = np.stack(e2s).astype(np.float32) if tris else z03
    uns = np.stack(uns).astype(np.float32) if tris else z03
    out["t_e1x"], out["t_e1y"], out["t_e1z"] = e1s.T
    out["t_e2x"], out["t_e2y"], out["t_e2z"] = e2s.T
    out["t_ux"], out["t_uy"], out["t_uz"] = uns.T
    out["t_lia"] = np.array(lias, np.float32)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


class _Rec(NamedTuple):
    """The closest-hit overwrite-chain carry, all-f32 lane vectors."""

    closest: jnp.ndarray
    found: jnp.ndarray  # 0/1 mask
    nx: jnp.ndarray
    ny: jnp.ndarray
    nz: jnp.ndarray
    cr: jnp.ndarray
    cg: jnp.ndarray
    cb: jnp.ndarray
    er: jnp.ndarray
    eg: jnp.ndarray
    eb: jnp.ndarray
    rf: jnp.ndarray
    li: jnp.ndarray
    # Extension material channels — None (an empty pytree slot, zero
    # carry cost) unless the scene has them.
    tp: jnp.ndarray = None
    io: jnp.ndarray = None
    ro: jnp.ndarray = None
    kr: jnp.ndarray = None
    kg: jnp.ndarray = None
    kb: jnp.ndarray = None
    ks: jnp.ndarray = None
    tx: jnp.ndarray = None
    xs: jnp.ndarray = None
    # normal-map channels (id / uv scale / strength)
    mi: jnp.ndarray = None
    mx: jnp.ndarray = None
    ms: jnp.ndarray = None


class ArrayPrims:
    """ScenePrims-compatible traversal sweeping SoA arrays with fori_loops
    — O(1) code size in primitive count (module docstring).

    `dyn_layout` / `bind()` follow the DynPrims operand protocol so the
    GPU kernel threads the arrays through as inputs with the same
    machinery; `PREREAD = False` tells the kernel to bind the refs THEMSELVES
    (the loop body reads `ref[i]` at a traced index — a scalar load per
    operand per iteration) instead of pre-reading N scalars, which would
    re-unroll the code the loop exists to avoid."""

    PREREAD = False

    def __init__(self, scene: scene_mod.Scene, unroll: int = None):
        self.scene = scene
        self.n_spheres = len(scene.spheres)
        self.n_planes = len(scene.planes)
        self.n_triangles = len(scene.triangles)
        self.unroll = max(int(DEFAULT_UNROLL if unroll is None else unroll),
                          1)
        # Dielectric channels thread through the sweep carry only when the
        # scene actually has them (two extra selects per primitive
        # iteration otherwise wasted on every stress-scale sweep).
        self.has_glass = scene.has_dielectrics
        self.has_rough = scene.has_rough_metals
        self.has_checker = scene.has_checker
        self.has_texture = scene.has_texture
        self.has_normal_map = scene.has_normal_map
        self.host_arrays = pack_scene_soa(scene)
        counts = {"s": self.n_spheres, "p": self.n_planes,
                  "t": self.n_triangles}
        from . import dynamic as dyn_mod

        keys = (*SPHERE_KEYS, *PLANE_KEYS, *TRI_KEYS)
        ext = dyn_mod.ext_mat_keys(scene)  # single source of truth
        if ext:
            keys = keys + tuple(
                f"{p}_{m}" for p in ("s", "p", "t") for m in ext
            )
        self.dyn_layout: List[Tuple[str, int]] = [
            (k, counts[k[0]])
            for k in keys
            if counts[k[0]] > 0
        ]
        # Oracle default: the arrays as jnp device constants (numpy would
        # reject traced fori indices). The GPU kernel re-binds input refs.
        self._a = {k: jnp.asarray(v) for k, v in self.host_arrays.items()}

    def bind(self, arrays) -> "ArrayPrims":
        """Bind indexables (jnp/np arrays, or input refs in-kernel) in the
        pack_scene_soa layout; only dyn_layout keys are read."""
        a = dict(self._a)
        for k, _n in self.dyn_layout:
            a[k] = arrays[k]
        self._a = a
        return self

    # ---- the fori_loop sweeps --------------------------------------------

    def _fori(self, n, body, carry):
        """fori_loop with MANUAL partial unroll: factor-u unrolling is u
        inlined body calls per iteration plus a statically-unrolled tail.

        CPU-only caveat (does not apply in the GPU kernel): XLA-CPU's
        FMA contraction can differ between this loop's body and
        straight-line code, a <= 1-ulp t divergence vs the baked sweep on
        general-position geometry (observed on mesh scenes; and inverting
        the experiment — unrolling small counts here — flips OTHER scenes
        off by 1 ulp instead, so bitwise baked/array equality on CPU is
        codegen luck either way). The packaged scenes and sphere stress
        fields are pinned bit-exact as-is (tests/test_arrayscene); mesh
        scenes pin exact ray counts + tight allclose (tests/test_mesh)."""
        if n == 0:
            return carry
        u = min(self.unroll, n)
        if u <= 1:
            return jax.lax.fori_loop(0, n, body, carry)
        main = n - (n % u)
        if main:

            def body_u(j, c):
                i0 = j * u
                for t in range(u):
                    c = body(i0 + t, c)
                return c

            carry = jax.lax.fori_loop(0, main // u, body_u, carry)
        for i in range(main, n):
            carry = body(i, carry)
        return carry

    def _hit_update(self, rec: _Rec, better, t, n_i: V3, pre: str, i,
                    lia) -> _Rec:
        a = self._a

        def sel(new, old):
            return jnp.where(better, new, old)

        return _Rec(
            closest=sel(t, rec.closest),
            found=sel(1.0, rec.found),
            nx=sel(n_i.x, rec.nx), ny=sel(n_i.y, rec.ny),
            nz=sel(n_i.z, rec.nz),
            cr=sel(a[f"{pre}_colr"][i], rec.cr),
            cg=sel(a[f"{pre}_colg"][i], rec.cg),
            cb=sel(a[f"{pre}_colb"][i], rec.cb),
            er=sel(a[f"{pre}_emir"][i], rec.er),
            eg=sel(a[f"{pre}_emig"][i], rec.eg),
            eb=sel(a[f"{pre}_emib"][i], rec.eb),
            rf=sel(a[f"{pre}_refl"][i], rec.rf),
            li=sel(lia, rec.li),
            tp=(sel(a[f"{pre}_transp"][i], rec.tp)
                if rec.tp is not None else None),
            io=(sel(a[f"{pre}_ior"][i], rec.io)
                if rec.io is not None else None),
            ro=(sel(a[f"{pre}_rough"][i], rec.ro)
                if rec.ro is not None else None),
            kr=(sel(a[f"{pre}_ckr"][i], rec.kr)
                if rec.kr is not None else None),
            kg=(sel(a[f"{pre}_ckg"][i], rec.kg)
                if rec.kg is not None else None),
            kb=(sel(a[f"{pre}_ckb"][i], rec.kb)
                if rec.kb is not None else None),
            ks=(sel(a[f"{pre}_cks"][i], rec.ks)
                if rec.ks is not None else None),
            tx=(sel(a[f"{pre}_txi"][i], rec.tx)
                if rec.tx is not None else None),
            xs=(sel(a[f"{pre}_txs"][i], rec.xs)
                if rec.xs is not None else None),
            mi=(sel(a[f"{pre}_nmi"][i], rec.mi)
                if rec.mi is not None else None),
            mx=(sel(a[f"{pre}_nmx"][i], rec.mx)
                if rec.mx is not None else None),
            ms=(sel(a[f"{pre}_nms"][i], rec.ms)
                if rec.ms is not None else None),
        )

    def _sweep_closest(self, o: V3, d: V3, t_min, rec: _Rec) -> _Rec:
        a = self._a

        def sphere(i, rec):
            c = V3(a["s_cx"][i], a["s_cy"][i], a["s_cz"][i])
            t = geom.intersect_sphere(o, d, c, a["s_r"][i], t_min,
                                      rec.closest)
            better = (t > 0.0) & (t < rec.closest)
            p_i = o + d * t
            n_i = vm.normalize((p_i - c) * a["s_invr"][i])
            return self._hit_update(rec, better, t, n_i, "s", i,
                                    a["s_lia"][i])

        def plane(i, rec):
            pt = V3(a["p_px"][i], a["p_py"][i], a["p_pz"][i])
            n_raw = V3(a["p_nx"][i], a["p_ny"][i], a["p_nz"][i])
            t = geom.intersect_plane(o, d, pt, n_raw, t_min, rec.closest)
            better = (t > 0.0) & (t < rec.closest)
            n_i = vm.splat(jnp.zeros_like(rec.closest)) + V3(
                a["p_ux"][i], a["p_uy"][i], a["p_uz"][i]
            )
            return self._hit_update(rec, better, t, n_i, "p", i, 0.0)

        def triangle(i, rec):
            v0 = V3(a["t_ax"][i], a["t_ay"][i], a["t_az"][i])
            e1 = V3(a["t_e1x"][i], a["t_e1y"][i], a["t_e1z"][i])
            e2 = V3(a["t_e2x"][i], a["t_e2y"][i], a["t_e2z"][i])
            t = geom.intersect_triangle(o, d, v0, e1, e2, t_min,
                                        rec.closest)
            better = (t > 0.0) & (t < rec.closest)
            n_i = vm.splat(jnp.zeros_like(rec.closest)) + V3(
                a["t_ux"][i], a["t_uy"][i], a["t_uz"][i]
            )
            return self._hit_update(rec, better, t, n_i, "t", i,
                                    a["t_lia"][i])

        # Reference flatten order: spheres, planes, triangles
        # (src/lib.rs:120-154) — the overwrite chain's tie semantics depend
        # on it (strictly-closer wins, shader.wgsl:279).
        rec = self._fori(self.n_spheres, sphere, rec)
        rec = self._fori(self.n_planes, plane, rec)
        rec = self._fori(self.n_triangles, triangle, rec)
        return rec

    # ---- ScenePrims interface --------------------------------------------

    def closest_hit(self, o: V3, d: V3, t_min=geom.RAY_EPS,
                    t_max=geom.T_FAR, mask=None) -> geom.Hit:
        """Brute-force closest-hit sweep (shader.wgsl:248-294) with fixed
        code size. `mask` accepted for interface parity and ignored (every
        lane sweeps everything, as the reference does)."""
        del mask
        zeros = jnp.zeros_like(o.x)
        glass_init = (zeros, zeros) if self.has_glass else (None, None)
        rough_init = (zeros,) if self.has_rough else (None,)
        checker_init = ((zeros,) * 4 if self.has_checker else (None,) * 4)
        tex_init = ((zeros,) * 2 if self.has_texture else (None,) * 2)
        nm_init = ((zeros,) * 3 if self.has_normal_map else (None,) * 3)
        rec = _Rec(zeros + t_max, *([zeros] * 12), *glass_init,
                   *rough_init, *checker_init, *tex_init, *nm_init)
        rec = self._sweep_closest(o, d, t_min, rec)
        found = rec.found != 0.0
        p = o + d * rec.closest
        normal = V3(rec.nx, rec.ny, rec.nz)
        front = vm.dot(d, normal) < 0.0
        normal = vm.where(front, normal, -normal)  # shader.wgsl:284-287
        lia = jnp.where(front, rec.li, 0.0)  # see geometry.closest_hit
        ck_col = (V3(rec.kr, rec.kg, rec.kb) if self.has_checker
                  else None)
        return geom.Hit(found, rec.closest, p, normal,
                        V3(rec.cr, rec.cg, rec.cb),
                        V3(rec.er, rec.eg, rec.eb), rec.rf, lia,
                        transparency=rec.tp, ior=rec.io, front=front,
                        roughness=rec.ro, checker_color=ck_col,
                        checker_scale=rec.ks, tex_index=rec.tx,
                        tex_scale=rec.xs, nm_index=rec.mi,
                        nm_scale=rec.mx, nm_strength=rec.ms)

    def occluded(self, o: V3, d: V3, t_min, t_max, mask=None) -> jnp.ndarray:
        """Any-hit shadow sweep (shader.wgsl:399-402)."""
        del mask
        a = self._a
        zeros = jnp.zeros_like(o.x)

        def hit_f(t):
            return jnp.where((t > 0.0) & (t < t_max), 1.0, 0.0)

        def sphere(i, blocked):
            c = V3(a["s_cx"][i], a["s_cy"][i], a["s_cz"][i])
            t = geom.intersect_sphere(o, d, c, a["s_r"][i], t_min, t_max)
            return jnp.maximum(blocked, hit_f(t))

        def plane(i, blocked):
            pt = V3(a["p_px"][i], a["p_py"][i], a["p_pz"][i])
            n_raw = V3(a["p_nx"][i], a["p_ny"][i], a["p_nz"][i])
            t = geom.intersect_plane(o, d, pt, n_raw, t_min, t_max)
            return jnp.maximum(blocked, hit_f(t))

        def triangle(i, blocked):
            v0 = V3(a["t_ax"][i], a["t_ay"][i], a["t_az"][i])
            e1 = V3(a["t_e1x"][i], a["t_e1y"][i], a["t_e1z"][i])
            e2 = V3(a["t_e2x"][i], a["t_e2y"][i], a["t_e2z"][i])
            t = geom.intersect_triangle(o, d, v0, e1, e2, t_min, t_max)
            return jnp.maximum(blocked, hit_f(t))

        blocked = self._fori(self.n_spheres, sphere, zeros)
        blocked = self._fori(self.n_planes, plane, blocked)
        blocked = self._fori(self.n_triangles, triangle, blocked)
        return blocked != 0.0


# ---------------------------------------------------------------------------
# Dynamic (animated) scenes at scale
# ---------------------------------------------------------------------------

# Per-light compact operand keys (traced scalars, pre-read in-kernel like
# DynPrims values — the light set is tiny). Sphere lights / triangle lights.
LIGHT_S_KEYS = ("ls_cx", "ls_cy", "ls_cz", "ls_r", "ls_er", "ls_eg", "ls_eb")
LIGHT_T_KEYS = ("lt_ax", "lt_ay", "lt_az", "lt_bx", "lt_by", "lt_bz",
                "lt_cx", "lt_cy", "lt_cz", "lt_er", "lt_eg", "lt_eb")

_FOUR_PI = 4.0 * 3.14159265359  # matches ops/dynamic.DynPrims._sweep


class ArrayDynPrims(ArrayPrims):
    """Dynamic (animated) scenes with the ArrayPrims traversal: runtime
    geometry/material values AND O(1) kernel code size in primitive count
    — the composition of --animate (ops/dynamic.py) with --accel array.

    bind() takes the ops.dynamic.pack_scene mapping (the dynamic step's
    `arrays` input) and computes the derived SoA quantities (plane unit
    normals, triangle edges/normals, 1/r, light 1/area) IN-GRAPH with the
    exact op sequence DynPrims uses for traced values (vm.normalize /
    vm.cross / vm.length on (N,) lanes), so a dynamic-array render is
    bit-identical to the fully-dynamic DynPrims render at equal values.

    NEE lights keep DynPrims semantics: the static light topology indexes
    compact per-light value arrays (`LIGHT_*_KEYS`) that ride as pre-read
    scalars in the kernel — O(n_lights), not O(N)."""

    def __init__(self, scene: scene_mod.Scene, unroll: int = None):
        super().__init__(scene, unroll=unroll)
        # Static light topology, like DynPrims (planes never sampled,
        # shader.wgsl:390-391).
        self.light_topology = []
        for i, s in enumerate(scene.spheres):
            if s.material.is_light:
                self.light_topology.append((scene_mod.SPHERE, i))
        for i, t in enumerate(scene.triangles):
            if t.material.is_light:
                self.light_topology.append((scene_mod.TRIANGLE, i))
        self._ls_idx = np.array(
            [i for k, i in self.light_topology if k == scene_mod.SPHERE],
            np.int32,
        )
        self._lt_idx = np.array(
            [i for k, i in self.light_topology if k == scene_mod.TRIANGLE],
            np.int32,
        )
        ns_l, nt_l = len(self._ls_idx), len(self._lt_idx)
        self.light_layout = (
            [(k, ns_l) for k in LIGHT_S_KEYS if ns_l] +
            [(k, nt_l) for k in LIGHT_T_KEYS if nt_l]
        )
        self.dyn_layout = list(self.dyn_layout) + self.light_layout
        # Static masks for the in-graph light_inv_area computation.
        self._s_is_light = np.array(
            [s.material.is_light for s in scene.spheres], bool)
        self._t_is_light = np.array(
            [t.material.is_light for t in scene.triangles], bool)

    # ---- in-graph derivation (pack_scene -> operand values) ---------------

    def operand_values(self, packed):
        """pack_scene-layout mapping (traced or numpy) -> {operand key:
        (count,) f32 array} for every dyn_layout key. All derived math is
        jnp, mirroring DynPrims' traced-value op sequences exactly."""
        a = {k: jnp.asarray(v, jnp.float32) for k, v in packed.items()}
        out = {}
        for k in ("s_cx", "s_cy", "s_cz", "s_r"):
            out[k] = a[k]
        if self.n_spheres:
            r = a["s_r"]
            out["s_invr"] = 1.0 / r
            out["s_lia"] = jnp.where(
                jnp.asarray(self._s_is_light),
                1.0 / (_FOUR_PI * r * r), 0.0,
            )
        else:
            out["s_invr"] = a["s_r"]
            out["s_lia"] = a["s_r"]
        from . import dynamic as dyn_mod

        mat_chs = dyn_mod.MAT_KEYS + dyn_mod.ext_mat_keys(self.scene)
        for pre in ("s", "p", "t"):
            for ch in mat_chs:
                out[f"{pre}_{ch}"] = a[f"{pre}_{ch}"]
        for k in ("p_px", "p_py", "p_pz", "p_nx", "p_ny", "p_nz"):
            out[k] = a[k]
        if self.n_planes:
            u = vm.normalize(V3(a["p_nx"], a["p_ny"], a["p_nz"]))
            out["p_ux"], out["p_uy"], out["p_uz"] = u.x, u.y, u.z
        else:
            out["p_ux"] = out["p_uy"] = out["p_uz"] = a["p_nx"]
        for k in ("t_ax", "t_ay", "t_az"):
            out[k] = a[k]
        if self.n_triangles:
            v0 = V3(a["t_ax"], a["t_ay"], a["t_az"])
            v1 = V3(a["t_bx"], a["t_by"], a["t_bz"])
            v2 = V3(a["t_cx"], a["t_cy"], a["t_cz"])
            e1, e2 = v1 - v0, v2 - v0
            cr = vm.cross(e1, e2)
            cr_len = vm.length(cr)
            u = cr / cr_len
            out["t_e1x"], out["t_e1y"], out["t_e1z"] = e1.x, e1.y, e1.z
            out["t_e2x"], out["t_e2y"], out["t_e2z"] = e2.x, e2.y, e2.z
            out["t_ux"], out["t_uy"], out["t_uz"] = u.x, u.y, u.z
            out["t_lia"] = jnp.where(
                jnp.asarray(self._t_is_light), 1.0 / (0.5 * cr_len), 0.0
            )
        else:
            z = a["t_ax"]
            for k in ("t_e1x", "t_e1y", "t_e1z", "t_e2x", "t_e2y", "t_e2z",
                      "t_ux", "t_uy", "t_uz", "t_lia"):
                out[k] = z
        # Compact per-light values (static topology indices).
        if len(self._ls_idx):
            idx = jnp.asarray(self._ls_idx)
            for op, key in zip(LIGHT_S_KEYS,
                               ("s_cx", "s_cy", "s_cz", "s_r",
                                "s_emir", "s_emig", "s_emib")):
                out[op] = a[key][idx]
        if len(self._lt_idx):
            idx = jnp.asarray(self._lt_idx)
            for op, key in zip(LIGHT_T_KEYS,
                               ("t_ax", "t_ay", "t_az", "t_bx", "t_by",
                                "t_bz", "t_cx", "t_cy", "t_cz",
                                "t_emir", "t_emig", "t_emib")):
                out[op] = a[key][idx]
        return out

    def kernel_operands(self, packed):
        """Host-side: the operand tuple for a render call (dyn_layout
        order), derived in-graph from the pack_scene `arrays` input."""
        vals = self.operand_values(packed)
        return tuple(vals[k] for k, _n in self.dyn_layout)

    # ---- binding -----------------------------------------------------------

    def bind(self, packed) -> "ArrayDynPrims":
        """Oracle path: bind the pack_scene mapping (derives SoA +
        light values in-graph)."""
        self._a = self.operand_values(packed)
        return self

    def bind_refs(self, refs) -> "ArrayDynPrims":
        """Kernel path: SoA sweep keys bind their input refs (the fori
        sweep reads ref[i] at traced indices); the compact light keys
        pre-read into traced scalars (DynPrims-style — O(n_lights))."""
        light_keys = {k for k, _n in self.light_layout}
        a = {}
        for k, n in self.dyn_layout:
            a[k] = ([refs[k][i] for i in range(n)] if k in light_keys
                    else refs[k])
        self._a = a
        return self

    # ---- NEE light list (tracer.direct_light consumes) ---------------------

    def light_list(self):
        """Same structure as DynPrims.light_list, from the compact
        per-light values."""
        a = self._a
        out = []
        s_pos = {int(i): j for j, i in enumerate(self._ls_idx)}
        t_pos = {int(i): j for j, i in enumerate(self._lt_idx)}
        for kind, i in self.light_topology:
            if kind == scene_mod.SPHERE:
                j = s_pos[i]
                c = V3(a["ls_cx"][j], a["ls_cy"][j], a["ls_cz"][j])
                emi = V3(a["ls_er"][j], a["ls_eg"][j], a["ls_eb"][j])
                out.append((kind, (c, a["ls_r"][j]), emi))
            else:
                j = t_pos[i]
                v0 = V3(a["lt_ax"][j], a["lt_ay"][j], a["lt_az"][j])
                v1 = V3(a["lt_bx"][j], a["lt_by"][j], a["lt_bz"][j])
                v2 = V3(a["lt_cx"][j], a["lt_cy"][j], a["lt_cz"][j])
                e1, e2 = v1 - v0, v2 - v0
                cr = vm.cross(e1, e2)
                cr_len = vm.length(cr)
                emi = V3(a["lt_er"][j], a["lt_eg"][j], a["lt_eb"][j])
                out.append((kind, (v0, v1, v2, cr / cr_len, 0.5 * cr_len),
                            emi))
        return out
