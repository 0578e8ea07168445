"""Dynamic (animated) scenes: traversal over runtime geometry arrays.

The default pipeline bakes geometry as compile-time constants — the right
call for the reference's static scenes (reference: src/lib.rs:386-565 never
rebuilds its primitive buffer; geometry is immutable for the process
lifetime, SURVEY.md §3.4). This module is the capability *extension* that
the reference's architecture actually gestures at: its scene lives in a GPU
storage buffer (src/lib.rs:301-305) and could have been re-uploaded per
frame. Here the analog is a set of SoA scalar arrays passed as runtime
inputs to the compiled step — change the values every frame, never
recompile.

Design (static shapes/topology, dynamic data):

* primitive COUNTS, flatten order, and the light set are fixed at build
  time from a template scene; every VALUE (centers, radii, vertices, plane
  points/normals, colors, emission, reflectivity) is a traced input;
* `DynPrims` implements the same closest_hit/occluded interface as
  geometry.ScenePrims, with the reference's exact semantics: same
  intersection routines, "strictly closer wins" overwrite chain
  (shader.wgsl:279), front-face flip, back-face-zeroed light_inv_area;
* inside the GPU kernel the arrays are inputs pre-read into
  per-primitive traced scalars once, outside the scheduler loop — the hot
  sweep then looks exactly like the baked one, minus the 0/±1 constant
  folding (an animated scene trades that much work for zero-recompile
  geometry updates);
* a light whose emission animates to zero still occupies its NEE slot
  (topology is static) — its contribution is exactly zero, matching the
  reference's own always-iterate-lights loop (shader.wgsl:342-347).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax.numpy as jnp
import numpy as np

from ..models import scene as scene_mod
from . import geometry as geom
from . import vecmath as vm
from .vecmath import V3

# Flat scalar-array layout: every key maps to a (count,) f32 array (or any
# indexable of scalars — the GPU kernel binds pre-read scalars).
SPHERE_KEYS = ("s_cx", "s_cy", "s_cz", "s_r")
PLANE_KEYS = ("p_px", "p_py", "p_pz", "p_nx", "p_ny", "p_nz")
TRI_KEYS = ("t_ax", "t_ay", "t_az", "t_bx", "t_by", "t_bz",
            "t_cx", "t_cy", "t_cz")
MAT_KEYS = ("colr", "colg", "colb", "emir", "emig", "emib", "refl")
# Dielectric material channels (models/scene.py Material extension). Only
# part of the operand layout when the template scene actually has
# dielectrics — scenes without keep their exact pre-glass layouts and
# compiled programs (the tracer's glass branch is statically gated on the
# same condition).
GLASS_KEYS = ("transp", "ior")
# Metal-roughness channel (same static-gating contract as GLASS_KEYS).
ROUGH_KEYS = ("rough",)
# Procedural checker texture channels (rgb + scale; scale 0 = untextured —
# the numeric encoding models/scene.py to_arrays emits).
CHECKER_KEYS = ("ckr", "ckg", "ckb", "cks")
# Image-texture channels (signed atlas id + uv scale; id 0 = untextured —
# models/scene.py texture_channel). The atlas itself is STATIC like the
# light topology (animators may vary the id/scale values, not the texels).
TEXTURE_KEYS = ("txi", "txs")
# Normal-map channels (signed atlas id + uv scale + tangential strength;
# id 0 = unmapped — models/scene.py normal_channel). Same static-atlas
# contract as TEXTURE_KEYS.
NORMALMAP_KEYS = ("nmi", "nmx", "nms")


def ext_mat_keys(scene) -> tuple:
    """The extension material-channel suffixes this scene's operand
    layouts carry — one source of truth for both the names AND the
    static-gate composition (scene_keys and the array-sweep layouts in
    ops/arrayscene.py all call this)."""
    return ((GLASS_KEYS if scene.has_dielectrics else ())
            + (ROUGH_KEYS if scene.has_rough_metals else ())
            + (CHECKER_KEYS if scene.has_checker else ())
            + (TEXTURE_KEYS if scene.has_texture else ())
            + (NORMALMAP_KEYS if scene.has_normal_map else ()))


def scene_keys(scene: scene_mod.Scene) -> List[Tuple[str, int]]:
    """The (key, length) list defining the packed layout for this scene's
    topology, in a stable order."""
    ns, np_, nt = (len(scene.spheres), len(scene.planes),
                   len(scene.triangles))
    mat = MAT_KEYS + ext_mat_keys(scene)
    out = [(k, ns) for k in SPHERE_KEYS]
    out += [(f"s_{m}", ns) for m in mat]
    out += [(k, np_) for k in PLANE_KEYS]
    out += [(f"p_{m}", np_) for m in mat]
    out += [(k, nt) for k in TRI_KEYS]
    out += [(f"t_{m}", nt) for m in mat]
    return out


def pack_scene(scene: scene_mod.Scene) -> Dict[str, np.ndarray]:
    """Scene -> the flat scalar-array dict (the animatable state)."""
    a = scene.to_arrays()

    def mats(prefix, col, emi, ref, tra, ior, rgh, ckc, cks, txi, txs,
             nmi, nmx, nms):
        return {
            f"{prefix}_colr": col[:, 0], f"{prefix}_colg": col[:, 1],
            f"{prefix}_colb": col[:, 2], f"{prefix}_emir": emi[:, 0],
            f"{prefix}_emig": emi[:, 1], f"{prefix}_emib": emi[:, 2],
            f"{prefix}_refl": ref, f"{prefix}_transp": tra,
            f"{prefix}_ior": ior, f"{prefix}_rough": rgh,
            f"{prefix}_ckr": ckc[:, 0], f"{prefix}_ckg": ckc[:, 1],
            f"{prefix}_ckb": ckc[:, 2], f"{prefix}_cks": cks,
            f"{prefix}_txi": txi, f"{prefix}_txs": txs,
            f"{prefix}_nmi": nmi, f"{prefix}_nmx": nmx,
            f"{prefix}_nms": nms,
        }

    out = {
        "s_cx": a["sphere_center"][:, 0], "s_cy": a["sphere_center"][:, 1],
        "s_cz": a["sphere_center"][:, 2], "s_r": a["sphere_radius"],
        "p_px": a["plane_point"][:, 0], "p_py": a["plane_point"][:, 1],
        "p_pz": a["plane_point"][:, 2], "p_nx": a["plane_normal"][:, 0],
        "p_ny": a["plane_normal"][:, 1], "p_nz": a["plane_normal"][:, 2],
        "t_ax": a["triangle_v0"][:, 0], "t_ay": a["triangle_v0"][:, 1],
        "t_az": a["triangle_v0"][:, 2], "t_bx": a["triangle_v1"][:, 0],
        "t_by": a["triangle_v1"][:, 1], "t_bz": a["triangle_v1"][:, 2],
        "t_cx": a["triangle_v2"][:, 0], "t_cy": a["triangle_v2"][:, 1],
        "t_cz": a["triangle_v2"][:, 2],
    }
    out.update(mats("s", a["sphere_color"], a["sphere_emission"],
                    a["sphere_reflectivity"], a["sphere_transparency"],
                    a["sphere_ior"], a["sphere_roughness"],
                    a["sphere_checker_color"], a["sphere_checker_scale"],
                    a["sphere_tex_index"], a["sphere_tex_scale"],
                    a["sphere_nm_index"], a["sphere_nm_scale"],
                    a["sphere_nm_strength"]))
    out.update(mats("p", a["plane_color"], a["plane_emission"],
                    a["plane_reflectivity"], a["plane_transparency"],
                    a["plane_ior"], a["plane_roughness"],
                    a["plane_checker_color"], a["plane_checker_scale"],
                    a["plane_tex_index"], a["plane_tex_scale"],
                    a["plane_nm_index"], a["plane_nm_scale"],
                    a["plane_nm_strength"]))
    out.update(mats("t", a["triangle_color"], a["triangle_emission"],
                    a["triangle_reflectivity"], a["triangle_transparency"],
                    a["triangle_ior"], a["triangle_roughness"],
                    a["triangle_checker_color"], a["triangle_checker_scale"],
                    a["triangle_tex_index"], a["triangle_tex_scale"],
                    a["triangle_nm_index"], a["triangle_nm_scale"],
                    a["triangle_nm_strength"]))
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


class DynPrims:
    """ScenePrims-compatible traversal whose per-primitive values come from
    arrays bound at trace time (`bind`). Counts/light-topology are fixed by
    the template scene.

    `animated`: optional set of pack_scene keys that actually vary at
    runtime. Keys outside the set are baked from the template scene as
    Python-float constants — vecmath's trace-time 0/±1 folding then applies
    to them exactly as in the fully-baked path, so e.g. an orbit animation
    (sphere centers + triangle verts move) keeps its axis-aligned planes at
    baked-sweep cost. None = every value is runtime (full generality).
    Derived static quantities (plane unit normals, triangle edges/areas)
    are precomputed host-side in stepwise float32 exactly like the baked
    path's constants (geometry.ScenePrims / geometry._tri_edges_f32), so a
    key declared static behaves bit-for-bit like the fully-baked scene."""

    def __init__(self, scene: scene_mod.Scene, animated=None):
        self.scene = scene
        self.n_spheres = len(scene.spheres)
        self.n_planes = len(scene.planes)
        self.n_triangles = len(scene.triangles)
        # Static gate for the dielectric channels (template-scene property,
        # like the light topology): scenes without dielectrics keep their
        # exact pre-glass operand layout and sweep code.
        self.has_glass = scene.has_dielectrics
        self.has_rough = scene.has_rough_metals
        self.has_checker = scene.has_checker
        self.has_texture = scene.has_texture
        self.has_normal_map = scene.has_normal_map
        # Static light topology: (kind, index within its kind array), in
        # primitive order, excluding planes (shader.wgsl:390-391).
        self.light_topology: List[Tuple[int, int]] = []
        for i, s in enumerate(scene.spheres):
            if s.material.is_light:
                self.light_topology.append((scene_mod.SPHERE, i))
        for i, t in enumerate(scene.triangles):
            if t.material.is_light:
                self.light_topology.append((scene_mod.TRIANGLE, i))
        full = pack_scene(scene)
        if animated is None:
            dyn_names = {k for k, v in full.items() if v.size > 0}
        else:
            dyn_names = {
                k for k, v in full.items() if k in animated and v.size > 0
            }
        # Runtime-value keys in the stable scene_keys order — the operand
        # layout the Pallas kernels and render_frame signatures share.
        self.dyn_layout: List[Tuple[str, int]] = [
            (k, n) for k, n in scene_keys(scene) if k in dyn_names
        ]
        self._static = {
            k: [float(x) for x in v]
            for k, v in full.items() if k not in dyn_names
        }
        self._a = None

    def bind(self, arrays) -> "DynPrims":
        """Bind a pack_scene-layout mapping of indexables (jnp arrays, or
        lists of pre-read scalars inside the GPU kernel). Only the
        dyn_layout keys are consumed; static keys come baked from the
        template scene."""
        a = dict(self._static)
        for k, _n in self.dyn_layout:
            a[k] = arrays[k]
        self._a = a
        return self

    # ---- per-primitive accessors (traced scalars) -------------------------

    def _sphere(self, i):
        a = self._a
        return (V3(a["s_cx"][i], a["s_cy"][i], a["s_cz"][i]), a["s_r"][i])

    def _plane(self, i):
        a = self._a
        return (V3(a["p_px"][i], a["p_py"][i], a["p_pz"][i]),
                V3(a["p_nx"][i], a["p_ny"][i], a["p_nz"][i]))

    def _triangle(self, i):
        a = self._a
        v0 = V3(a["t_ax"][i], a["t_ay"][i], a["t_az"][i])
        v1 = V3(a["t_bx"][i], a["t_by"][i], a["t_bz"][i])
        v2 = V3(a["t_cx"][i], a["t_cy"][i], a["t_cz"][i])
        return v0, v1, v2

    def _mat(self, prefix, i):
        a = self._a
        col = V3(a[f"{prefix}_colr"][i], a[f"{prefix}_colg"][i],
                 a[f"{prefix}_colb"][i])
        emi = V3(a[f"{prefix}_emir"][i], a[f"{prefix}_emig"][i],
                 a[f"{prefix}_emib"][i])
        return col, emi, a[f"{prefix}_refl"][i]

    def _glass(self, prefix, i):
        """(transparency, ior) for one primitive, or None when the
        template scene has no dielectrics (keys absent by design)."""
        if not self.has_glass:
            return None
        a = self._a
        return a[f"{prefix}_transp"][i], a[f"{prefix}_ior"][i]

    def _rough(self, prefix, i):
        """Roughness for one primitive, or None when the template scene
        has no rough metals (key absent by design)."""
        if not self.has_rough:
            return None
        return self._a[f"{prefix}_rough"][i]

    def _checker(self, prefix, i):
        """(checker rgb V3-components tuple, scale) for one primitive, or
        None when the template scene has no checker textures."""
        if not self.has_checker:
            return None
        a = self._a
        return (a[f"{prefix}_ckr"][i], a[f"{prefix}_ckg"][i],
                a[f"{prefix}_ckb"][i], a[f"{prefix}_cks"][i])

    def _texture(self, prefix, i):
        """(signed atlas id, uv scale) for one primitive, or None when the
        template scene has no image textures."""
        if not self.has_texture:
            return None
        a = self._a
        return a[f"{prefix}_txi"][i], a[f"{prefix}_txs"][i]

    def _normalmap(self, prefix, i):
        """(signed atlas id, uv scale, strength) for one primitive, or
        None when the template scene has no normal maps."""
        if not self.has_normal_map:
            return None
        a = self._a
        return (a[f"{prefix}_nmi"][i], a[f"{prefix}_nmx"][i],
                a[f"{prefix}_nms"][i])

    @staticmethod
    def _is_static(*vs) -> bool:
        return all(
            isinstance(c, (int, float)) for v in vs for c in (v.x, v.y, v.z)
        )

    @staticmethod
    def _plane_unit(n_raw: V3):
        """Unit plane normal: static floats get the baked path's stepwise
        f32 host math (geometry.ScenePrims); traced values keep the
        fully-dynamic path's rsqrt normalize."""
        if DynPrims._is_static(n_raw):
            n = np.array([n_raw.x, n_raw.y, n_raw.z], np.float32)
            u = n / np.float32(np.sqrt(np.dot(n, n)))
            return V3(float(u[0]), float(u[1]), float(u[2]))
        return vm.normalize(n_raw)

    @staticmethod
    def _tri_derived(v0: V3, v1: V3, v2: V3):
        """(e1, e2, n_unit, half_cr_len): stepwise-f32 host constants for
        static vertices (mirrors geometry._tri_edges_f32), traced math
        otherwise."""
        if DynPrims._is_static(v0, v1, v2):
            v0a = np.array(v0, np.float32)
            e1a = np.array(v1, np.float32) - v0a
            e2a = np.array(v2, np.float32) - v0a
            cr = np.cross(e1a, e2a).astype(np.float32)
            cr_len = np.float32(np.sqrt(np.float32(np.dot(cr, cr))))
            u = cr / cr_len
            return (
                V3(float(e1a[0]), float(e1a[1]), float(e1a[2])),
                V3(float(e2a[0]), float(e2a[1]), float(e2a[2])),
                V3(float(u[0]), float(u[1]), float(u[2])),
                float(np.float32(0.5) * cr_len),
            )
        e1, e2 = v1 - v0, v2 - v0
        cr = vm.cross(e1, e2)
        cr_len = vm.length(cr)
        return e1, e2, cr / cr_len, 0.5 * cr_len

    def _sweep(self):
        """Yield (intersect_fn(o,d,t_min,t_max), normal_fn(p), material,
        light_inv_area, glass, rough) per primitive in the reference
        flatten order (spheres, planes, triangles — lib.rs:120-154);
        `glass` is (transparency, ior) or None when the template has no
        dielectrics; `rough`, `checker`, `tex` and `nm` likewise for the
        metal-roughness, checker-texture, image-texture and normal-map
        channels."""
        four_pi = 4.0 * 3.14159265359
        light_idx = set(self.light_topology)
        for i in range(self.n_spheres):
            c, r = self._sphere(i)

            def isect(o, d, t_min, t_max, c=c, r=r):
                return geom.intersect_sphere(o, d, c, r, t_min, t_max)

            def norm(p, c=c, r=r):
                return vm.normalize((p - c) * (1.0 / r))

            lia = (
                1.0 / (four_pi * r * r)
                if (scene_mod.SPHERE, i) in light_idx else 0.0
            )
            yield (isect, norm, self._mat("s", i), lia,
                   self._glass("s", i), self._rough("s", i),
                   self._checker("s", i), self._texture("s", i),
                   self._normalmap("s", i))
        for i in range(self.n_planes):
            pt, n_raw = self._plane(i)
            n_unit = self._plane_unit(n_raw)

            def isect(o, d, t_min, t_max, pt=pt, n_raw=n_raw):
                return geom.intersect_plane(o, d, pt, n_raw, t_min, t_max)

            def norm(p, n_unit=n_unit):
                return vm.splat(jnp.zeros_like(p.x)) + n_unit

            yield (isect, norm, self._mat("p", i), 0.0,
                   self._glass("p", i), self._rough("p", i),
                   self._checker("p", i), self._texture("p", i),
                   self._normalmap("p", i))
        for i in range(self.n_triangles):
            v0, v1, v2 = self._triangle(i)
            e1, e2, n_unit, half_len = self._tri_derived(v0, v1, v2)

            def isect(o, d, t_min, t_max, v0=v0, e1=e1, e2=e2):
                return geom.intersect_triangle(o, d, v0, e1, e2, t_min, t_max)

            def norm(p, n_unit=n_unit):
                return vm.splat(jnp.zeros_like(p.x)) + n_unit

            lia = (
                1.0 / half_len
                if (scene_mod.TRIANGLE, i) in light_idx else 0.0
            )
            yield (isect, norm, self._mat("t", i), lia,
                   self._glass("t", i), self._rough("t", i),
                   self._checker("t", i), self._texture("t", i),
                   self._normalmap("t", i))

    # ---- ScenePrims interface ---------------------------------------------

    def closest_hit(self, o: V3, d: V3, t_min=geom.RAY_EPS, t_max=geom.T_FAR,
                    mask=None) -> geom.Hit:
        """Brute-force closest-hit sweep with the reference's overwrite
        chain (shader.wgsl:248-294): each strictly-closer hit overwrites
        the record — identical winners to ScenePrims' one-hot formulation."""
        del mask
        lanes = o.x
        zeros = jnp.zeros_like(lanes)
        closest = zeros + t_max
        found = jnp.zeros_like(lanes, dtype=bool)
        normal = vm.splat(zeros)
        col = vm.splat(zeros)
        emi = vm.splat(zeros)
        refl = zeros
        lia_v = zeros
        tp_v = zeros if self.has_glass else None
        io_v = zeros if self.has_glass else None
        ro_v = zeros if self.has_rough else None
        ck = ((vm.splat(zeros), zeros) if self.has_checker
              else (None, None))
        tx = ((zeros, zeros) if self.has_texture else (None, None))
        nm = ((zeros,) * 3 if self.has_normal_map else (None,) * 3)
        for (isect, norm, (m_col, m_emi, m_refl), lia, gl, rg,
             cc, tex, nmc) in self._sweep():
            t = isect(o, d, t_min, closest)
            better = (t > 0.0) & (t < closest)
            closest = jnp.where(better, t, closest)
            found = found | better
            p_i = o + d * t
            normal = vm.where(better, norm(p_i), normal)
            col = vm.where(better, vm.splat(zeros) + m_col, col)
            emi = vm.where(better, vm.splat(zeros) + m_emi, emi)
            refl = jnp.where(better, m_refl, refl)
            lia_v = jnp.where(better, zeros + lia, lia_v)
            if gl is not None:
                tp_v = jnp.where(better, zeros + gl[0], tp_v)
                io_v = jnp.where(better, zeros + gl[1], io_v)
            if rg is not None:
                ro_v = jnp.where(better, zeros + rg, ro_v)
            if cc is not None:
                ck = (vm.where(better,
                               vm.splat(zeros) + V3(cc[0], cc[1], cc[2]),
                               ck[0]),
                      jnp.where(better, zeros + cc[3], ck[1]))
            if tex is not None:
                tx = (jnp.where(better, zeros + tex[0], tx[0]),
                      jnp.where(better, zeros + tex[1], tx[1]))
            if nmc is not None:
                nm = tuple(jnp.where(better, zeros + nmc[j], nm[j])
                           for j in range(3))
        p = o + d * closest
        front = vm.dot(d, normal) < 0.0
        normal = vm.where(front, normal, -normal)
        lia_v = jnp.where(front, lia_v, 0.0)  # see geometry.closest_hit
        return geom.Hit(found, closest, p, normal, col, emi, refl, lia_v,
                        transparency=tp_v, ior=io_v, front=front,
                        roughness=ro_v, checker_color=ck[0],
                        checker_scale=ck[1], tex_index=tx[0],
                        tex_scale=tx[1], nm_index=nm[0], nm_scale=nm[1],
                        nm_strength=nm[2])

    def occluded(self, o: V3, d: V3, t_min, t_max, mask=None) -> jnp.ndarray:
        del mask
        blocked = jnp.zeros_like(o.x, dtype=bool)
        for (isect, _norm, _mat, _lia, _gl, _rg, _cc, _tx,
             _nm) in self._sweep():
            t = isect(o, d, t_min, t_max)
            blocked = blocked | ((t > 0.0) & (t < t_max))
        return blocked

    # ---- NEE light list (tracer.direct_light consumes) ---------------------

    def light_list(self):
        """Per NEE light: the same (kind, data, emission) structure
        tracer._Light carries, with traced values."""
        out = []
        for kind, i in self.light_topology:
            if kind == scene_mod.SPHERE:
                c, r = self._sphere(i)
                _col, emi, _refl = self._mat("s", i)
                out.append((kind, (c, r), emi))
            else:
                v0, v1, v2 = self._triangle(i)
                _e1, _e2, n_unit, half_len = self._tri_derived(v0, v1, v2)
                _col, emi, _refl = self._mat("t", i)
                out.append((kind, (v0, v1, v2, n_unit, half_len), emi))
        return out
