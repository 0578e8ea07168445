"""Per-lane gathered grid traversal: fewer primitive tests per ray.

The brute sweeps (baked/array) are test-throughput-bound at many-
primitive scales, because EVERY lane tests EVERY primitive every bounce.
The reference's own answer was a uniform grid it built
but never consumed (reference: src/lib.rs:158-246; its shader stays brute
force, src/shader.wgsl:248-294). This module consumes that grid with a per-lane walk:
primitive records are fetched per lane from tables, the way texels are.

* **Tables, not constants**: primitive geometry/materials pack channel-
  major into a (rows, 128) f32 table; the grid's CSR indices + offsets
  into a (rows, 128) i32 table. In the jnp oracle they are device
  constants, read by the row-sweep gather (tracer.gather_texels); in the
  GPU kernel they ride as whole-array global-memory operands (Pallas
  rejects captured constants -- same protocol as the texel atlas), read
  by direct indexed loads.
* **Flat-cursor walk**: each lane holds a cursor (cell, k) into its own
  DDA walk; one walk step either TESTS the k-th primitive of its current
  cell (one fetch of the geometry channels) or ADVANCES its DDA one cell
  (two fetches of the CSR offsets). All lanes step in lockstep; a lane is
  done when its cell-entry t passes its closest hit (or its t_max) or its
  walk exits the grid. The walk records only (t, winner index); the
  winner's MATERIAL channels are fetched once per bounce after the walk --
  no per-test material selects at all.
* **Planes sweep densely** (baked, before the walk): infinite extent has
  no cell range -- the reference's grid gives planes degenerate AABBs too
  (lib.rs:177). Their closest hit also seeds the walk's early-exit bound.
* **f32-only lane state**: cell coords / cursors / winner ids are exact
  small integers carried as f32, cast to i32 at the fetch sites.

Semantics: identical primitive math as the brute sweeps (the same
geometry.intersect_* on the fetched values), winner = strictly-closest.
The TEST ORDER differs from the reference flatten order (planes first,
then grid order, with multi-cell primitives re-tested per cell), so exact
fp TIES can pick a different winner -- measure-zero, same caveat as the
block-culled reorder (ops/accel.py). The jnp oracle runs the IDENTICAL
walk, so oracle-vs-kernel stays exact.

Status: opt-in (`--accel gathered`); the brute sweeps stay the auto
policy. Whether the walk beats the array sweep on a GPU, where a per-lane
load is native, has not been measured (ROADMAP S6).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import scene as scene_mod
from . import geometry as geom
from . import grid as grid_mod
from . import vecmath as vm
from .vecmath import V3

# Grid resolution heuristic factor (cells per axis ~ n^(1/3) * factor).
# The reference uses 1.5 (lib.rs:198); probe23's walk simulation confirms
# 1.5 near-optimal for the stress fields (finer grids trade tests for
# steps and inflate the offsets table the advance block must sweep).
DEFAULT_FACTOR = 1.5

_BIG = 3.0e38  # < f32 inf: avoids inf*0 NaNs in the slab/DDA math


def _pad128(a: np.ndarray, fill=0) -> np.ndarray:
    n = len(a)
    r = -(-max(n, 1) // 128)
    out = np.full(r * 128, fill, a.dtype)
    out[:n] = a
    return out.reshape(r, 128)


def gather_rows(tab, idx, lo, hi, direct=False):
    """Per-lane fetch ``tab.flat[idx]`` from a (rows, 128) table, limited
    to the static row range [lo, hi). `idx` is a GLOBAL flat index into
    the table (callers add their channel block's base offset). Thin alias
    of tracer.gather_texels, which is dtype-polymorphic, so the f32 tables
    here ride the same code as the i32 texel atlas; `direct` as there."""
    return gather_rows_multi(tab, (idx,), lo, hi, direct)[0]


def gather_rows_multi(tab, idxs, lo, hi, direct=False):
    """gather_rows for several index grids at once (the CSR offsets fetch
    reads off[ci] and off[ci+1] together); empty ranges return f32 zeros
    (this module's tables are f32)."""
    from . import tracer as tracer_mod

    if lo >= hi:
        return [jnp.zeros(jnp.bitwise_and(i, 127).shape, jnp.float32)
                for i in idxs]
    return tracer_mod.gather_texels_multi(tab, idxs, hi, lo, direct)


class WalkState(NamedTuple):
    """Per-lane walk state — ALL f32 lane grids (exact small integers where
    integral).
    """

    active: jnp.ndarray  # 0/1
    ix: jnp.ndarray  # cell coords
    iy: jnp.ndarray
    iz: jnp.ndarray
    tmx: jnp.ndarray  # DDA per-axis next-boundary t
    tmy: jnp.ndarray
    tmz: jnp.ndarray
    cur: jnp.ndarray  # CSR cursor (flat index into the indices block)
    end: jnp.ndarray  # CSR range end
    t_best: jnp.ndarray  # closest accepted t so far (or the walk cap)
    best: jnp.ndarray  # winner primitive id (-1 none)


N_STATE = len(WalkState._fields)


class GatheredPrims:
    """ScenePrims-compatible traversal: per-lane grid walks with lane-axis
    gathers. Static scenes only (the grid is host-built); extension
    material channels supported (post-walk winner gathers)."""

    def __init__(self, scene: scene_mod.Scene, factor: float = None):
        self.scene = scene
        self.ns = len(scene.spheres)
        self.nt = len(scene.triangles)
        if self.ns + self.nt == 0:
            raise ValueError("gathered traversal needs spheres/triangles")
        factor = DEFAULT_FACTOR if factor is None else float(factor)

        # --- grid over spheres+triangles only (planes sweep densely) ----
        scene_nop = dataclasses.replace(scene, planes=())
        g = grid_mod.build_uniform_grid(scene_nop, factor=factor)
        self.dims = tuple(int(v) for v in g.dims)
        self.grid_min = tuple(float(v) for v in g.grid_min)
        cell = 1.0 / np.asarray(g.inv_cell_size, np.float64)
        self.cell = tuple(float(v) for v in cell)
        self.grid_max = tuple(
            float(self.grid_min[i] + self.cell[i] * self.dims[i])
            for i in range(3)
        )
        self.n_cells = int(np.prod(g.dims))

        # Safe walk-trip bound: a DDA visits <= nx+ny+nz+1 cells; tests are
        # bounded by the largest that many bucket sizes.
        sizes = np.sort(np.diff(g.offsets))[::-1]
        visits = int(sum(self.dims)) + 2
        self.max_trips = int(sizes[:visits].sum()) + visits + 4

        # --- i32 table: CSR indices block, then offsets block ------------
        idx_blk = _pad128(g.indices.astype(np.int32))
        off_blk = _pad128(g.offsets.astype(np.int32))
        self.idx_rows = idx_blk.shape[0]
        self.off_base = self.idx_rows  # row offset of the offsets block
        self.off_rows = off_blk.shape[0]
        self.i32_tab_host = np.concatenate([idx_blk, off_blk], 0)

        # --- f32 table: channel-major blocks ------------------------------
        # Walk-time geometry channels first, then post-walk material
        # channels (each block is rows-of-one-channel; static row bounds
        # keep every gather sweeping only its own block).
        from . import arrayscene
        from . import dynamic as dyn_mod

        soa = arrayscene.pack_scene_soa(scene)
        ext = dyn_mod.ext_mat_keys(scene)
        self._ext = ext
        blocks = []  # (name, (rows,128) array)

        def add(name, arr):
            blocks.append((name, _pad128(np.asarray(arr, np.float32))))

        if self.ns:
            for k in ("s_cx", "s_cy", "s_cz", "s_r"):
                add(k, soa[k])
        if self.nt:
            for k in ("t_ax", "t_ay", "t_az", "t_e1x", "t_e1y", "t_e1z",
                      "t_e2x", "t_e2y", "t_e2z"):
                add(k, soa[k])
        # Post-walk channels: normals + materials (+ extensions).
        mat_s = ("s_invr", "s_colr", "s_colg", "s_colb", "s_emir", "s_emig",
                 "s_emib", "s_refl", "s_lia")
        mat_t = ("t_ux", "t_uy", "t_uz", "t_colr", "t_colg", "t_colb",
                 "t_emir", "t_emig", "t_emib", "t_refl", "t_lia")
        if self.ns:
            for k in mat_s + tuple(f"s_{m}" for m in ext):
                add(k, soa[k])
        if self.nt:
            for k in mat_t + tuple(f"t_{m}" for m in ext):
                add(k, soa[k])
        self._row_of = {}
        row = 0
        parts = []
        for name, blk in blocks:
            self._row_of[name] = (row, row + blk.shape[0])
            row += blk.shape[0]
            parts.append(blk)
        self.f32_tab_host = np.concatenate(parts, 0)

        # Extension-channel static gates (Hit fields None when absent).
        self.has_glass = scene.has_dielectrics
        self.has_rough = scene.has_rough_metals
        self.has_checker = scene.has_checker
        self.has_texture = scene.has_texture
        self.has_normal_map = scene.has_normal_map

        # Dense plane sweep (baked constants; empty scene -> no-op prims).
        self._planes = geom.ScenePrims(
            tuple((scene_mod.PLANE, p) for p in scene.planes),
            tex_channel=scene.texture_channel,
            nm_channel=scene.normal_channel,
        ) if scene.planes else None

        # Oracle default: tables as jnp constants, row-sweep fetches. The
        # kernel re-binds global-memory refs via bind_tables.
        self._f32 = jnp.asarray(self.f32_tab_host)
        self._i32 = jnp.asarray(self.i32_tab_host)
        self._direct = False

    # -- kernel operand protocol (like the texel atlas) --------------------

    def table_operands(self):
        """Host-side operand tuple (f32 table, i32 table)."""
        return (jnp.asarray(self.f32_tab_host),
                jnp.asarray(self.i32_tab_host, jnp.int32))

    def bind_tables(self, f32_ref, i32_ref) -> "GatheredPrims":
        """Kernel path: read the tables through refs by indexed loads."""
        self._f32 = f32_ref
        self._i32 = i32_ref
        self._direct = True
        return self

    # -- channel fetch helpers ----------------------------------------------

    def _fetch(self, name, local_id):
        """Gather channel `name` at per-lane local primitive id."""
        lo, hi = self._row_of[name]
        return gather_rows(self._f32, local_id + (lo * 128), lo, hi,
                           self._direct)

    def _fetch_sphere_geo(self, sid):
        c = self._fetch_sphere_center(sid)
        r = self._fetch("s_r", sid)
        return c, r

    def _fetch_sphere_center(self, sid):
        """Center only — the post-walk winner gather needs no radius (the
        normal uses s_invr), so skip the s_r block sweep there."""
        return V3(self._fetch("s_cx", sid), self._fetch("s_cy", sid),
                  self._fetch("s_cz", sid))

    def _fetch_tri_geo(self, tid):
        a = V3(self._fetch("t_ax", tid), self._fetch("t_ay", tid),
               self._fetch("t_az", tid))
        e1 = V3(self._fetch("t_e1x", tid), self._fetch("t_e1y", tid),
                self._fetch("t_e1z", tid))
        e2 = V3(self._fetch("t_e2x", tid), self._fetch("t_e2y", tid),
                self._fetch("t_e2z", tid))
        return a, e1, e2

    # -- walk ------------------------------------------------------------

    def walk_start(self, o: V3, d: V3, mask, t_cap) -> WalkState:
        """Initialize the per-lane DDA. `t_cap` is the walk's early-exit
        bound AND the strictly-closer comparison base (the dense plane
        sweep's closest t, or the shadow ray's t_max)."""
        zeros = jnp.zeros_like(o.x)
        lo = self.grid_min
        hi = self.grid_max
        t0 = zeros
        t1 = zeros + _BIG
        for ax, (oc, dc) in enumerate(((o.x, d.x), (o.y, d.y), (o.z, d.z))):
            par = jnp.abs(dc) < 1e-12
            inv = 1.0 / jnp.where(par, 1.0, dc)
            a = (lo[ax] - oc) * inv
            b = (hi[ax] - oc) * inv
            amin = jnp.minimum(a, b)
            amax = jnp.maximum(a, b)
            inside = (oc >= lo[ax]) & (oc <= hi[ax])
            amin = jnp.where(par, jnp.where(inside, 0.0, _BIG), amin)
            amax = jnp.where(par, jnp.where(inside, _BIG, 0.0), amax)
            t0 = jnp.maximum(t0, amin)
            t1 = jnp.minimum(t1, amax)
        act = (t0 <= t1) & (t0 < t_cap)
        if mask is not None:
            act = act & mask
        t_in = jnp.maximum(t0, 0.0)

        ics = []
        tms = []
        for ax, (oc, dc) in enumerate(((o.x, d.x), (o.y, d.y), (o.z, d.z))):
            pos = oc + dc * (t_in + 1e-5)
            ic = jnp.clip(jnp.floor((pos - lo[ax]) * (1.0 / self.cell[ax])),
                          0.0, float(self.dims[ax] - 1))
            pos_next = lo[ax] + (ic + jnp.where(dc >= 0.0, 1.0, 0.0)
                                 ) * self.cell[ax]
            par = jnp.abs(dc) < 1e-12
            inv = 1.0 / jnp.where(par, 1.0, dc)
            tm = jnp.abs((pos_next - oc) * inv)
            tm = jnp.where(par, _BIG, tm)
            ics.append(ic)
            tms.append(tm)
        ci = ics[0] + ics[1] * float(self.dims[0]) + ics[2] * float(
            self.dims[0] * self.dims[1])
        cur, end = self._cell_range(ci)
        actf = jnp.where(act, 1.0, 0.0)
        return WalkState(actf, ics[0], ics[1], ics[2], tms[0], tms[1],
                         tms[2], cur * actf, end * actf, t_cap,
                         zeros - 1.0)

    def _cell_range(self, ci_f):
        """CSR (start, end) of the f32 cell id (two shared-row gathers of
        the offsets block)."""
        ci = ci_f.astype(jnp.int32) + (self.off_base * 128)
        lo, hi = self.off_base, self.off_base + self.off_rows
        s, e = gather_rows_multi(self._i32, (ci, ci + 1), lo, hi,
                                 self._direct)
        return s.astype(jnp.float32), e.astype(jnp.float32)

    def walk_step(self, o: V3, d: V3, t_min, st: WalkState,
                  any_hit=False) -> WalkState:
        """One flat-cursor iteration: test-or-advance, vector-masked.
        `any_hit`: stop the lane at its first accepted hit (shadow rays) —
        t_best then stays the caller's cap and only `best` flags the hit.
        """
        act = st.active != 0.0
        has_work = act & (st.cur < st.end)

        # ---- test block -------------------------------------------------
        pid_f = gather_rows(self._i32, st.cur.astype(jnp.int32), 0,
                            self.idx_rows, self._direct).astype(jnp.float32)
        t = None
        if self.ns and self.nt:
            is_s = pid_f < float(self.ns)
            sid = jnp.clip(pid_f, 0.0, float(self.ns - 1)).astype(jnp.int32)
            tid = jnp.clip(pid_f - float(self.ns), 0.0,
                           float(self.nt - 1)).astype(jnp.int32)
            c, r = self._fetch_sphere_geo(sid)
            ts = geom.intersect_sphere(o, d, c, r, t_min, st.t_best)
            a, e1, e2 = self._fetch_tri_geo(tid)
            tt = geom.intersect_triangle(o, d, a, e1, e2, t_min, st.t_best)
            t = jnp.where(is_s, ts, tt)
        elif self.ns:
            sid = pid_f.astype(jnp.int32)
            c, r = self._fetch_sphere_geo(sid)
            t = geom.intersect_sphere(o, d, c, r, t_min, st.t_best)
        else:
            tid = pid_f.astype(jnp.int32)
            a, e1, e2 = self._fetch_tri_geo(tid)
            t = geom.intersect_triangle(o, d, a, e1, e2, t_min, st.t_best)
        ok = has_work & (t > 0.0) & (t < st.t_best)
        if any_hit:
            best = jnp.where(ok, pid_f, st.best)
            t_best = st.t_best
            done_hit = ok
        else:
            t_best = jnp.where(ok, t, st.t_best)
            best = jnp.where(ok, pid_f, st.best)
            done_hit = jnp.zeros_like(ok)
        cur = jnp.where(has_work, st.cur + 1.0, st.cur)

        # ---- advance block ----------------------------------------------
        adv = act & (~has_work)
        use_x = (st.tmx <= st.tmy) & (st.tmx <= st.tmz)
        use_y = (~use_x) & (st.tmy <= st.tmz)
        use_z = (~use_x) & (~use_y)
        t_exit = jnp.where(use_x, st.tmx, jnp.where(use_y, st.tmy, st.tmz))
        done_t = t_exit > t_best

        def axis_step(flag, ic, tm, dc, ax):
            stp = jnp.where(dc >= 0.0, 1.0, -1.0)
            ic2 = ic + stp
            oob = (ic2 < 0.0) | (ic2 >= float(self.dims[ax]))
            tm2 = tm + jnp.abs(self.cell[ax] / jnp.where(
                jnp.abs(dc) < 1e-12, 1.0, dc))
            return ic2, tm2, flag & oob

        ix2, tmx2, oob_x = axis_step(use_x, st.ix, st.tmx, d.x, 0)
        iy2, tmy2, oob_y = axis_step(use_y, st.iy, st.tmy, d.y, 1)
        iz2, tmz2, oob_z = axis_step(use_z, st.iz, st.tmz, d.z, 2)
        oob = (use_x & oob_x) | (use_y & oob_y) | (use_z & oob_z)
        done = adv & (done_t | oob)
        move = adv & (~done)

        ix = jnp.where(move & use_x, ix2, st.ix)
        iy = jnp.where(move & use_y, iy2, st.iy)
        iz = jnp.where(move & use_z, iz2, st.iz)
        tmx = jnp.where(move & use_x, tmx2, st.tmx)
        tmy = jnp.where(move & use_y, tmy2, st.tmy)
        tmz = jnp.where(move & use_z, tmz2, st.tmz)
        ci = ix + iy * float(self.dims[0]) + iz * float(
            self.dims[0] * self.dims[1])
        new_cur, new_end = self._cell_range(ci)
        cur = jnp.where(move, new_cur, cur)
        end = jnp.where(move, new_end, st.end)

        active = act & (~done) & (~done_hit)
        return WalkState(jnp.where(active, 1.0, 0.0), ix, iy, iz,
                         tmx, tmy, tmz, cur, end, t_best, best)

    def _run_walk(self, o: V3, d: V3, t_min, st: WalkState, any_hit=False):
        """Drive walk_step to completion — a vector-carry while loop (the
        same loop in the oracle and the kernel)."""

        def cond(c):
            it, st = c
            # A count, not jnp.any: Triton has no reduce_or.
            live = jnp.sum(jnp.where(st.active != 0.0, 1, 0))
            return (it < self.max_trips) & (live > 0)

        def body(c):
            it, st = c
            return it + 1, self.walk_step(o, d, t_min, st, any_hit=any_hit)

        _, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
        return st

    # -- ScenePrims interface ----------------------------------------------

    def closest_hit(self, o: V3, d: V3, t_min=geom.RAY_EPS,
                    t_max=geom.T_FAR, mask=None) -> geom.Hit:
        zeros = jnp.zeros_like(o.x)
        # Dense plane prepass: its closest t caps the walk. (Tie semantics:
        # a gathered hit needs t strictly below the plane's — differs from
        # the reference flatten order on exact fp ties only.)
        if self._planes is not None:
            ph = self._planes.closest_hit(o, d, t_min, t_max)
            t_cap = jnp.where(ph.found, ph.t, zeros + t_max)
        else:
            ph = None
            t_cap = zeros + t_max

        st = self.walk_start(o, d, mask, t_cap)
        st = self._run_walk(o, d, t_min, st, any_hit=False)

        won = st.best >= 0.0
        pid = st.best
        t = st.t_best

        # Post-walk winner gathers: geometry for the normal + material
        # channels (+ extensions) — once per bounce, not per test.
        ext = self._ext
        if self.ns and self.nt:
            is_s = won & (pid < float(self.ns))
            is_t = won & (~(pid < float(self.ns)))
        elif self.ns:
            is_s, is_t = won, jnp.zeros_like(won)
        else:
            is_s, is_t = jnp.zeros_like(won), won

        p = o + d * t
        nrm = vm.splat(zeros)
        col = vm.splat(zeros)
        emi = vm.splat(zeros)
        refl = zeros
        lia = zeros
        ch = {m: zeros for m in ext}
        if self.ns:
            sid = jnp.clip(pid, 0.0, float(self.ns - 1)).astype(jnp.int32)
            c = self._fetch_sphere_center(sid)
            invr = self._fetch("s_invr", sid)
            n_s = vm.normalize((p - c) * invr)
            nrm = vm.where(is_s, n_s, nrm)
            col = vm.where(is_s, V3(self._fetch("s_colr", sid),
                                    self._fetch("s_colg", sid),
                                    self._fetch("s_colb", sid)), col)
            emi = vm.where(is_s, V3(self._fetch("s_emir", sid),
                                    self._fetch("s_emig", sid),
                                    self._fetch("s_emib", sid)), emi)
            refl = jnp.where(is_s, self._fetch("s_refl", sid), refl)
            lia = jnp.where(is_s, self._fetch("s_lia", sid), lia)
            for m in ext:
                ch[m] = jnp.where(is_s, self._fetch(f"s_{m}", sid), ch[m])
        if self.nt:
            tid = jnp.clip(pid - float(self.ns), 0.0,
                           float(self.nt - 1)).astype(jnp.int32)
            n_t = V3(self._fetch("t_ux", tid), self._fetch("t_uy", tid),
                     self._fetch("t_uz", tid))
            nrm = vm.where(is_t, n_t, nrm)
            col = vm.where(is_t, V3(self._fetch("t_colr", tid),
                                    self._fetch("t_colg", tid),
                                    self._fetch("t_colb", tid)), col)
            emi = vm.where(is_t, V3(self._fetch("t_emir", tid),
                                    self._fetch("t_emig", tid),
                                    self._fetch("t_emib", tid)), emi)
            refl = jnp.where(is_t, self._fetch("t_refl", tid), refl)
            lia = jnp.where(is_t, self._fetch("t_lia", tid), lia)
            for m in ext:
                ch[m] = jnp.where(is_t, self._fetch(f"t_{m}", tid), ch[m])

        # Merge with the plane prepass (walk winner is strictly closer by
        # construction: t < t_cap <= plane t).
        found = won
        if ph is not None:
            use_p = ph.found & (~won)
            found = won | ph.found
            t = jnp.where(use_p, ph.t, t)
            p = vm.where(use_p, ph.p, p)
            # ph.normal is already front-faced by ScenePrims; undo is not
            # needed — front-facing below is applied to the RAW normal, so
            # use the plane's raw (pre-flip) orientation via its front flag.
            nrm_p = vm.where(ph.front, ph.normal, -ph.normal)
            nrm = vm.where(use_p, nrm_p, nrm)
            col = vm.where(use_p, ph.color, col)
            emi = vm.where(use_p, ph.emission, emi)
            refl = jnp.where(use_p, ph.reflectivity, refl)
            lia = jnp.where(use_p, 0.0, lia)  # planes never NEE-sampled
            if ph.transparency is not None and "transp" in ch:
                ch["transp"] = jnp.where(use_p, ph.transparency,
                                         ch["transp"])
                ch["ior"] = jnp.where(use_p, ph.ior, ch["ior"])
            if ph.roughness is not None and "rough" in ch:
                ch["rough"] = jnp.where(use_p, ph.roughness, ch["rough"])
            if ph.checker_scale is not None and "cks" in ch:
                ch["ckr"] = jnp.where(use_p, ph.checker_color.x, ch["ckr"])
                ch["ckg"] = jnp.where(use_p, ph.checker_color.y, ch["ckg"])
                ch["ckb"] = jnp.where(use_p, ph.checker_color.z, ch["ckb"])
                ch["cks"] = jnp.where(use_p, ph.checker_scale, ch["cks"])
            if ph.tex_index is not None and "txi" in ch:
                ch["txi"] = jnp.where(use_p, ph.tex_index, ch["txi"])
                ch["txs"] = jnp.where(use_p, ph.tex_scale, ch["txs"])
            if ph.nm_index is not None and "nmi" in ch:
                ch["nmi"] = jnp.where(use_p, ph.nm_index, ch["nmi"])
                ch["nmx"] = jnp.where(use_p, ph.nm_scale, ch["nmx"])
                ch["nms"] = jnp.where(use_p, ph.nm_strength, ch["nms"])

        front = vm.dot(d, nrm) < 0.0
        nrm = vm.where(front, nrm, -nrm)
        lia = jnp.where(front, lia, 0.0)  # see geometry.closest_hit
        return geom.Hit(
            found, t, p, nrm, col, emi, refl, lia,
            transparency=ch.get("transp"), ior=ch.get("ior"), front=front,
            roughness=ch.get("rough"),
            checker_color=(V3(ch["ckr"], ch["ckg"], ch["ckb"])
                           if "cks" in ch else None),
            checker_scale=ch.get("cks"), tex_index=ch.get("txi"),
            tex_scale=ch.get("txs"), nm_index=ch.get("nmi"),
            nm_scale=ch.get("nmx"), nm_strength=ch.get("nms"),
        )

    def occluded(self, o: V3, d: V3, t_min, t_max, mask=None):
        blocked_p = (self._planes.occluded(o, d, t_min, t_max)
                     if self._planes is not None else None)
        walk_mask = mask
        if blocked_p is not None and walk_mask is not None:
            walk_mask = walk_mask & (~blocked_p)
        elif blocked_p is not None:
            walk_mask = ~blocked_p
        st = self.walk_start(o, d, walk_mask, t_max)
        st = self._run_walk(o, d, t_min, st, any_hit=True)
        hit = st.best >= 0.0
        return hit if blocked_p is None else (hit | blocked_p)
