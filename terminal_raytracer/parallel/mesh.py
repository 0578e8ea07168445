"""Multi-chip scale-out: shard_map over a ('px', 'sp') device mesh.

The reference is strictly single-GPU (SURVEY.md §2 parallelism inventory:
pixel-data-parallel within one chip, nothing across chips). This module is
the capability *extension* mandated by SURVEY.md §5.8, designed the JAX way:
pick a mesh, annotate shardings, let XLA insert collectives.

Two orthogonal parallel axes. The cards of one host are joined all to all,
so the mesh follows the algorithm alone:

* ``px`` — pixel-row data parallelism. The image (and all frame state) is
  sharded along H. Embarrassingly parallel: the only collectives are the
  scalar psums of the frame's ray count and occupancy denominator. Each
  shard runs the single-card renderer (the megakernel or the XLA oracle)
  on its own row block.

* ``sp`` — sample parallelism, with *reference-exact* adaptive-sampling
  statistics. The global base budget max(4, spp/4) (shader.wgsl:513) is
  split evenly across the 'sp' shards; their per-channel sample sums and
  sums-of-squares are merged with one ``psum``, so the
  variance -> extra-budget decision (shader.wgsl:555-562) is computed from
  *all* base samples exactly as a single card would. The extra budget is
  then partitioned across the shards (remainder to the lowest indices),
  each renders its share, and a second ``psum`` merges the extra sums
  before the reference's normalization (shader.wgsl:600-610). The only
  deviation from single-card output is RNG: shards draw from decorrelated
  seed chains — the same "parity modulo RNG" the reference's own
  nondeterministic host seeding implies (lib.rs:423). The base budget
  splits like the extra budget: floor/ceil shares with the remainder to
  the lowest shard indices (a runtime per-shard quota into one compiled
  kernel), so ANY (spp, n_sp) combination is valid. The sample split runs
  its phases on the XLA path (the megakernel fuses both phases, so it has
  no seam for the psum between them).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models import scene as scene_mod
from ..ops import tonemap as tm
from ..ops import tracer as tracer_mod
from ..ops import vecmath as vm
from ..ops.vecmath import V3
from ..runtime.state import FrameOutput, FrameState, resolve_backend

SEED_STRIDE = 2654435761  # Knuth multiplicative-hash odd constant


def make_mesh(n_px: Optional[int] = None, n_sp: int = 1, devices=None) -> Mesh:
    """Build a ('px', 'sp') mesh from the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_px is None:
        n_px = len(devices) // n_sp
    if n_px * n_sp != len(devices):
        devices = devices[: n_px * n_sp]
    arr = np.array(devices).reshape(n_px, n_sp)
    return Mesh(arr, ("px", "sp"))


def _psum_v3(v: V3, axis: str) -> V3:
    return V3(
        jax.lax.psum(v.x, axis),
        jax.lax.psum(v.y, axis),
        jax.lax.psum(v.z, axis),
    )


def make_sharded_render_step(
    scene: scene_mod.Scene,
    mesh: Mesh,
    full_color: bool = True,
    backend: str = "auto",
    jit: bool = True,
    transport: str = None,
    dynamic: bool = False,
    animated=None,
    denoise: float = 0.0,
    denoise_passes: int = 3,
    tonemap="reference",
    exposure: float = 0.0,
    interpret: bool = False,
):
    """Build the multi-card render step.

    Returns (step, init_state_fn). `step(state, pose, seed, frame_number) ->
    FrameOutput` with all [.., H, ..] outputs/state sharded along 'px' and
    replicated along 'sp'. `init_state_fn()` builds the sharded FrameState.

    `dynamic` / `animated`: animated scenes on the mesh — the step gains a
    trailing `arrays` argument (ops/dynamic.pack_scene values, replicated
    over both axes; geometry values are tiny next to the pixel planes) and
    the per-shard renderers consume them as runtime values, exactly like
    the single-card dynamic step (Engine passes the same call shape).

    `denoise` > 0: the à-trous reconstruction filter runs on the sharded
    row blocks before tonemap — each pass exchanges halo rows with the
    neighbor shards (ops/denoise.denoise_sharded, ppermute along 'px'),
    bit-identical to the single-card filter of the full image.

    `backend`: 'auto' runs the megakernel on GPU meshes with sp == 1 and
    the XLA path otherwise; 'pallas' with sp > 1 is refused. `interpret`
    as in make_render_step.
    """
    tm_mode = tm.parse_mode(tonemap)
    tm_scale = 2.0 ** float(exposure)
    n_px = mesh.shape["px"]
    n_sp = mesh.shape["sp"]
    h, w = scene.height, scene.width
    if h % n_px:
        raise ValueError(f"height={h} not divisible by px={n_px}")
    rows = h // n_px
    spp = scene.samples_per_pixel
    base_full = tracer_mod.base_sample_count(spp)
    # Per-shard base shares: floor for everyone, remainder to the lowest
    # shard indices (like the extra-budget split below) — shard i renders
    # base_lo or base_lo+1 samples via a runtime quota into one compiled
    # kernel, so no (spp, n_sp) combination is rejected.
    base_lo, base_rem = divmod(base_full, n_sp)
    base_hi = base_lo + (1 if base_rem else 0)

    if backend == "auto" and n_sp > 1:
        backend = "jnp"
    backend = resolve_backend(backend, platform=mesh.devices.flat[0].platform)
    if backend == "pallas" and n_sp > 1:
        raise ValueError("sample-split shards (sp > 1) run on the jnp "
                         "backend; use backend='jnp' or 'auto'")

    # ---- per-shard renderers -------------------------------------------------

    if n_sp == 1:
        # Pure pixel-row DP: each shard runs the single-card renderer on
        # its row block (the megakernel, or the XLA oracle).
        if backend == "pallas":
            from ..ops import pallas_kernel

            shard_kernel = pallas_kernel.make_render_frame(
                scene, shard_rows=rows, transport=transport,
                dynamic=dynamic, animated=animated, interpret=interpret)
        else:
            tracer = tracer_mod.PathTracer(scene,
                                           transport=transport,
                                           dynamic=dynamic,
                                           dyn_animated=animated)

        def shard_render(pose, seed, frame_number, arrays=None):
            px_i = jax.lax.axis_index("px")
            y0 = px_i.astype(jnp.int32) * rows
            if backend == "pallas":
                args = (pose, seed, frame_number) + (
                    (arrays,) if dynamic else ())
                cur, var, tot, rays, occ = shard_kernel(*args, y0=y0)
                # Shard-local executed sweep capacity (the occupancy
                # denominator, occ = rays / cap) — psum-mergeable across
                # shards where the ratio itself is not.
                cap = rays / jnp.maximum(occ, 1e-9)
            else:
                if dynamic:
                    tracer.prims.bind({k: jnp.asarray(v, jnp.float32)
                                       for k, v in arrays.items()})
                y = y0 + jax.lax.broadcasted_iota(jnp.int32, (rows, w), 0)
                x = jax.lax.broadcasted_iota(jnp.int32, (rows, w), 1)
                cam = tracer_mod.cam_from_pose(pose)
                cur, var, tot, rays = tracer.render_lanes(
                    cam, x, y, seed, frame_number
                )
                rays = jnp.sum(rays)
                cap = None  # the jnp oracle doesn't surface iterations
            return cur, var, tot, rays, cap

    else:
        # Sample-split with reference-exact adaptive statistics (module
        # docstring). Both backends decompose into base phase -> psum ->
        # budget -> extra phase -> psum -> global normalization. With a
        # non-divisible base budget (base_rem > 0) the per-shard quota is a
        # RUNTIME scalar (floor or floor+1) into one compiled kernel whose
        # static quota is the ceiling.
        tracer = tracer_mod.PathTracer(scene,
                                       base_quota=base_hi,
                                       transport=transport,
                                       dynamic=dynamic,
                                       dyn_animated=animated)

        def shard_render(pose, seed, frame_number, arrays=None):
            px_i = jax.lax.axis_index("px")
            sp_i = jax.lax.axis_index("sp")
            y0 = px_i.astype(jnp.int32) * rows
            # Decorrelate sample shards exactly like frames decorrelate:
            # bump the seed by shard index (host seeds are random u32).
            seed_l = jnp.asarray(seed, jnp.uint32) + sp_i.astype(
                jnp.uint32
            ) * jnp.uint32(SEED_STRIDE)
            # This shard's base share (remainder to the lowest indices).
            my_base = jnp.int32(base_lo) + jnp.where(
                sp_i.astype(jnp.int32) < base_rem, 1, 0
            )

            cam = tracer_mod.cam_from_pose(pose)
            y = y0 + jax.lax.broadcasted_iota(jnp.int32, (rows, w), 0)
            x = jax.lax.broadcasted_iota(jnp.int32, (rows, w), 1)
            xf = x.astype(jnp.float32)
            yf = y.astype(jnp.float32)

            if dynamic:
                tracer.prims.bind({k: jnp.asarray(v, jnp.float32)
                                   for k, v in arrays.items()})
            state0 = tracer.seed_lanes(x, y, seed_l, frame_number)
            run = lambda c: tracer._run_regen_jnp(cam, xf, yf, c)
            state, csum, csumsq, rays_l = tracer.base_phase(
                cam, xf, yf, state0, None, run,
                quota=(my_base.astype(jnp.float32) if base_rem
                       else None),
            )
            rays = jnp.sum(rays_l)

            # Merge base statistics across 'sp': variance over ALL
            # base_full samples, as on a single chip (shader.wgsl:555-558).
            csum_g = _psum_v3(csum, "sp")
            csumsq_g = _psum_v3(csumsq, "sp")
            rays = jax.lax.psum(rays, "sp")
            mean = csum_g * (1.0 / base_full)
            var = (
                (csumsq_g.x * (1.0 / base_full) - mean.x * mean.x)
                + (csumsq_g.y * (1.0 / base_full) - mean.y * mean.y)
                + (csumsq_g.z * (1.0 / base_full) - mean.z * mean.z)
            )

            if base_full >= spp:
                current = csum_g * (1.0 / spp)
                total = jnp.zeros_like(var) + float(base_full)
                return current, var, total, rays, None

            # Global extra budget (shader.wgsl:561-562), partitioned across
            # the 'sp' shards (remainder to the lowest shard indices).
            needs = var > tracer_mod.ADAPTIVE_VAR_THRESHOLD
            additional = jnp.where(
                needs,
                jnp.minimum(
                    float(spp - base_full),
                    jnp.floor(var * tracer_mod.ADAPTIVE_VAR_SCALE),
                ),
                0.0,
            )
            share_q = jnp.floor(additional / n_sp)
            share_rem = additional - share_q * n_sp
            my_extra = share_q + jnp.where(
                sp_i.astype(jnp.float32) < share_rem, 1.0, 0.0
            )

            zeros = jnp.zeros_like(xf)
            esum, rays_b_l = tracer.extra_phase(
                cam, xf, yf, state, my_extra, zeros, run,
                samp0=(jnp.zeros_like(x) + my_base if base_rem else None),
            )
            rays_b = jnp.sum(rays_b_l)
            esum_g = _psum_v3(esum, "sp")
            rays = rays + jax.lax.psum(rays_b, "sp")

            # Single-chip normalization (shader.wgsl:600-610) on the merged
            # sums: adaptive pixels average over all samples actually taken;
            # everyone else divides the base sum by spp.
            total = float(base_full) + additional
            current = vm.where(
                needs,
                (csum_g + esum_g) * (1.0 / total),
                csum_g * (1.0 / spp),
            )
            return current, var, total, rays, None

    def step(state: FrameState, pose, seed, frame_number,
             arrays=None) -> FrameOutput:
        cur, variance, samples, rays, cap = shard_render(
            pose, seed, frame_number, arrays)
        fn = jnp.asarray(frame_number, jnp.float32)
        alpha = jnp.where(fn == 0.0, 1.0, 1.0 / (fn + 1.0))
        cur_s = jnp.stack([cur.x, cur.y, cur.z])
        acc = state.acc * (1.0 - alpha) + cur_s * alpha
        acc_v = V3(acc[0], acc[1], acc[2])
        if denoise > 0.0:
            from ..ops import denoise as dn

            total = samples * (fn + 1.0)
            acc_v = dn.denoise_sharded(
                acc_v, variance / jnp.maximum(total, 1.0), denoise,
                denoise_passes, "px", n_px)
        if full_color:
            rgb = tm.tonemap_fullcolor(acc_v, tm_mode, tm_scale)
            glyphs = jnp.zeros(rgb.shape[:2], jnp.uint8)
        else:
            rgb, glyphs = tm.tonemap_ascii(acc_v, tm_mode, tm_scale)
        rays_g = jax.lax.psum(rays, "px")
        if cap is None:
            occ_g = jnp.float32(-1.0)
        else:
            # Mesh-wide measured occupancy: global owed sweeps over global
            # executed sweep capacity (per-shard iters psum-merged).
            occ_g = rays_g / jnp.maximum(jax.lax.psum(cap, "px"), 1.0)
        return FrameOutput(
            state=FrameState(acc=acc, variance=variance, samples=samples),
            rgb=rgb,
            glyphs=glyphs,
            rays=rays_g,
            occupancy=occ_g,
        )

    state_specs = FrameState(
        acc=P(None, "px", None), variance=P("px", None), samples=P("px", None)
    )
    out_specs = FrameOutput(
        state=state_specs,
        rgb=P("px", None, None),
        glyphs=P("px", None),
        rays=P(),
        occupancy=P(),
    )
    in_specs = (state_specs, P(), P(), P())
    if dynamic:
        # The pack_scene value arrays are replicated over both axes (tiny
        # next to the pixel planes; every shard traces the full geometry).
        from ..ops.dynamic import pack_scene

        in_specs = in_specs + ({k: P() for k in pack_scene(scene)},)
    # check_vma off: the tracer's loop carries start from constant zeros,
    # which the varying-manual-axes checker flags against the loop's varying
    # outputs; the collectives here (pmean/psum) are hand-placed.
    sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    if jit:
        sharded = jax.jit(sharded, donate_argnums=(0,))
    sharded.backend = backend

    def init_state() -> FrameState:
        zero = FrameState(
            acc=jnp.zeros((3, h, w), jnp.float32),
            variance=jnp.zeros((h, w), jnp.float32),
            samples=jnp.zeros((h, w), jnp.float32),
        )
        return jax.device_put(
            zero,
            FrameState(
                acc=NamedSharding(mesh, state_specs.acc),
                variance=NamedSharding(mesh, state_specs.variance),
                samples=NamedSharding(mesh, state_specs.samples),
            ),
        )

    return sharded, init_state
