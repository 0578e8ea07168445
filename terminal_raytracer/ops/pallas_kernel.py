"""The path-regeneration megakernel for NVIDIA GPUs (Pallas, Triton route).

The reference renders with one GPU compute dispatch, one thread per pixel
and all path state in registers (src/shader.wgsl:497-622). This kernel is
that design in Pallas: a 1-D grid over power-of-two blocks of pixels of the
row-major image, one lane per thread (block = num_warps x 32), and the
whole per-pixel Monte-Carlo loop inside the kernel.

All of the path-tracing math is `ops.tracer.PathTracer` -- the same code the
jnp oracle runs. The kernel body is `render_lanes_regen` under a
vector-carry `lax.while_loop` driver (Triton lowers `scf.while` with tensor
carries), so every lane works through its own sample quota at its own pace
and a block exits the moment none of its lanes owes work. The XLA oracle, by
contrast, steps every lane of the frame for as long as any lane is alive.

Memory layout:

* scene geometry is baked into the kernel as compile-time constants
  (models/scene.py), so the hot loop reads no memory for it;
* pose, seed, frame number, the row offset `y0` and the dynamic-scene value
  arrays are ordinary global-memory inputs that every program reads with
  scalar loads;
* lookup tables (the texel atlas, the gathered traversal's primitive and
  grid tables) are global-memory inputs read by direct indexed loads
  (tracer.gather_texels_multi `direct=True`);
* outputs (current-sample colour planes, variance, sample counts, per-pixel
  ray counts) are stored with the block's edge mask, plus one executed
  iteration count per block for the occupancy metric.

The kernel compiles only for a GPU. Off the GPU it runs only when the
caller passes `interpret=True` (the Pallas interpreter; the tests do).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..models import scene as scene_mod
from . import tracer as tracer_mod
from .vecmath import V3

# Lanes per program: one lane per thread, 4 warps. On an H100 at north-star
# settings 64 and 128 lanes tie and 256 is slower (PERF.md).
BLOCK = 128


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def require_device(interpret: bool) -> None:
    """The kernel compiles only for a GPU: anywhere else it needs an
    explicit `interpret=True`, never a silent fallback."""
    platform = jax.default_backend()
    if not interpret and platform != "gpu":
        raise ValueError(
            f"backend='pallas' compiles its kernel only for a GPU, and the "
            f"device platform is {platform!r}; use backend='jnp', or pass "
            "interpret=True to run the kernel in the Pallas interpreter")


def _dyn_layout(tracer):
    """The tracer's runtime-value operand layout [(key, count)]: the
    dynamic tracer's traced scene values (DynPrims), or the array-resident
    sweep's SoA arrays (ArrayPrims). Empty for baked tracers."""
    return getattr(tracer.prims, "dyn_layout", [])


def _table_ops(tracer):
    """Host-side: the lookup-table operands appended AFTER the
    scene-value operands -- Pallas rejects captured array constants, so
    each table rides as one whole-array input: the texel atlas of an
    atlas-reading tracer (primitive textures and/or a sky texture), then
    the gathered traversal's f32 and i32 tables. () when none is read."""
    from . import gathered as gathered_mod

    ops = ()
    if getattr(tracer, "needs_atlas", False):
        ops += (jnp.asarray(tracer.tex_atlas_host, jnp.int32),)
    if isinstance(tracer.prims, gathered_mod.GatheredPrims):
        ops += tracer.prims.table_operands()
    return ops


def _bind_front(tracer, rest):
    """Pop the scene-value refs, then the table refs (_table_ops order),
    off the front of `rest` and bind them into the tracer. DynPrims (PREREAD) gets each
    value pre-read into per-primitive traced scalars, once, outside the
    scheduler loop (ops/dynamic.py design note); ArrayPrims gets the refs
    THEMSELVES -- its fori_loop sweep reads `ref[i]` at a traced index,
    which a pre-read would re-unroll into the O(N) code the loop exists to
    avoid."""
    layout = _dyn_layout(tracer)
    if layout:
        refs = dict(zip((k for k, _n in layout), rest))
        if hasattr(tracer.prims, "bind_refs"):
            # ArrayDynPrims: SoA sweep keys keep their refs, compact light
            # keys pre-read (O(n_lights)).
            tracer.prims.bind_refs(refs)
        elif getattr(tracer.prims, "PREREAD", True):
            tracer.prims.bind({k: [refs[k][i] for i in range(n)]
                               for k, n in layout})
        else:
            tracer.prims.bind(refs)
        rest = rest[len(layout):]
    if getattr(tracer, "needs_atlas", False):
        tracer.bind_texture(rest[0], direct=True)
        rest = rest[1:]
    from . import gathered as gathered_mod

    if isinstance(tracer.prims, gathered_mod.GatheredPrims):
        tracer.prims.bind_tables(rest[0], rest[1])
        rest = rest[2:]
    return rest


def _auto_scene_ops(tracer):
    """The operand tuple a STATIC array-resident tracer (accel='array')
    appends automatically at call time -- its own SoA value arrays. None
    when the caller supplies the values (dynamic mode) or the traversal is
    baked."""
    if getattr(tracer, "dynamic", False):
        return None
    arrays = getattr(tracer.prims, "host_arrays", None)
    if arrays is None:
        return None
    return _dyn_ops(tracer.prims.dyn_layout, arrays)


def _dyn_ops(layout, arrays):
    """Host-side: the operand tuple for a render call, in layout order."""
    return tuple(jnp.asarray(arrays[k], jnp.float32) for k, _n in layout)


def _dyn_values(tracer, arrays):
    """Host-side operand tuple from a dynamic step's pack_scene `arrays`
    input: ArrayDynPrims derives its SoA + light operands in-graph
    (kernel_operands); DynPrims operands are the arrays themselves."""
    prims = tracer.prims
    if hasattr(prims, "kernel_operands"):
        return prims.kernel_operands(arrays)
    return _dyn_ops(prims.dyn_layout, arrays)


def make_render_frame(
    scene: scene_mod.Scene,
    block: int = None,
    interpret: bool = False,
    unbiased: bool = False,
    transport: str = None,
    shard_rows: int = None,
    accel: str = "auto",
    dynamic: bool = False,
    animated=None,
    chunk_base="auto",
    chunk_extra="auto",
):
    """Build `render_frame(pose, seed, frame_number[, arrays], y0=0)`
    backed by the megakernel. Returns (current V3[h, w], variance,
    total_samples, rays_total, occupancy) like the oracle's
    `render_frame(..., with_occ=True)`.

    `block`: lanes per program, a power of two >= 32 (one lane per
    thread); None = the module's BLOCK.

    `interpret`: run in the Pallas interpreter instead of compiling for
    the GPU. Must be explicit; off the GPU the build refuses without it.

    `shard_rows`: when set, the kernel renders a `shard_rows x width` row
    block of the (globally-sized) image starting at runtime row offset `y0`
    -- the per-device body of the shard_map multi-card step
    (parallel/mesh.py). Pixel seeds and camera rays use global coordinates,
    so shards tile seamlessly.

    `accel`: traversal (see PathTracer).

    `dynamic`: geometry/material values become runtime inputs (ops/dynamic.py
    layout) and `render_frame` gains a trailing `arrays` argument, so
    animated scenes re-invoke one compiled kernel with new values.
    `animated`: with `dynamic`, the pack_scene keys that actually vary --
    the rest folds back to baked constants (DynPrims).

    `chunk_base`/`chunk_extra`: heavy-pixel chunk-split sizes (PathTracer;
    'auto' = on above CHUNK_AUTO_THRESHOLD primitives)."""
    require_device(interpret)
    block = block or BLOCK
    if block < 32 or block & (block - 1):
        raise ValueError(f"block={block} must be a power of two >= 32")
    tracer = tracer_mod.PathTracer(scene, unbiased=unbiased,
                                   transport=transport, accel=accel,
                                   dynamic=dynamic, dyn_animated=animated,
                                   chunk_base=chunk_base,
                                   chunk_extra=chunk_extra)
    layout = _dyn_layout(tracer)
    h, w = scene.height, scene.width
    h_out = shard_rows if shard_rows is not None else h
    n_pix = h_out * w
    n_blocks = _cdiv(n_pix, block)
    # Safety bound only -- the pending count is the real exit condition.
    max_iters = (scene.samples_per_pixel + 1) * scene.max_depth + 4

    def kernel(pose_ref, seed_ref, frame_ref, y0_ref, *rest):
        rest = _bind_front(tracer, rest)
        r_ref, g_ref, b_ref, var_ref, tot_ref, rays_ref, it_ref = rest
        lane = pl.program_id(0) * block + jax.lax.broadcasted_iota(
            jnp.int32, (block,), 0)
        # Lanes past the image (or this shard's row block) are ballast:
        # they draw no RNG, trace nothing and count no rays (the
        # reference's bounds check, shader.wgsl:503).
        active = lane < n_pix
        ly = lane // w
        xs = lane - ly * w
        ys = y0_ref[0] + ly
        xf = xs.astype(jnp.float32)
        yf = ys.astype(jnp.float32)
        cam = tracer_mod.cam_from_pose(pose_ref)
        iters = []

        def driver(carry0):
            def cond(c):
                it, carry = c
                return (it < max_iters) & (tracer.regen_pending(carry) > 0)

            def body(c):
                it, carry = c
                return it + 1, tracer.regen_step(cam, xf, yf, carry)

            it, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry0))
            iters.append(it)
            return carry

        cur, var, tot, rays = tracer.render_lanes_regen(
            cam, xs, ys, seed_ref[0], frame_ref[0], active=active,
            driver=driver)
        for ref, val in ((r_ref, cur.x), (g_ref, cur.y), (b_ref, cur.z),
                         (var_ref, var), (tot_ref, tot), (rays_ref, rays)):
            plt.store(ref, val, mask=active)
        # Chunked tracers run the driver once per chunk: executed
        # iterations add up across its invocations.
        it_ref[...] = jnp.full((1,), sum(iters[1:], iters[0]), jnp.int32)

    lane_spec = pl.BlockSpec((block,), lambda i: (i,))
    plane = jax.ShapeDtypeStruct((n_pix,), jnp.float32)
    whole = pl.BlockSpec()  # the whole array, for scalar/indexed loads
    n_in = 4 + len(layout) + len(_table_ops(tracer))
    call = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[whole] * n_in,
        # r, g, b, variance, total samples, per-pixel ray counts, and the
        # executed iteration count of each block.
        out_specs=[lane_spec] * 6 + [pl.BlockSpec((1,), lambda i: (i,))],
        out_shape=[plane] * 6 + [jax.ShapeDtypeStruct((n_blocks,), jnp.int32)],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=block // 32,
                                           num_stages=1),
        interpret=interpret,
        name="regen_megakernel",
    )

    # Measured sweep-weighted lane occupancy: owed sweeps (rays) over
    # executed lane-iteration sweeps. Each executed iteration runs every
    # lane of the block through one traversal + nee_sweeps shadow sweeps,
    # busy or not.
    sweeps_per_iter = 1.0 + float(tracer.nee_sweeps)

    def _finish(outs):
        r, g, b, var, tot, rays, iters = outs
        shape = (h_out, w)
        lane_iters = jnp.sum(iters).astype(jnp.float32) * float(block)
        rays_sum = jnp.sum(rays)
        occ = rays_sum / jnp.maximum(lane_iters * sweeps_per_iter, 1.0)
        return (V3(r.reshape(shape), g.reshape(shape), b.reshape(shape)),
                var.reshape(shape), tot.reshape(shape), rays_sum, occ)

    def _scalars(pose, seed, frame_number, y0):
        return (jnp.asarray(pose, jnp.float32),
                jnp.asarray(seed, jnp.uint32).reshape((1,)),
                jnp.asarray(frame_number, jnp.int32).reshape((1,)),
                jnp.asarray(y0, jnp.int32).reshape((1,)))

    if dynamic:

        def render_frame(pose, seed, frame_number, arrays, y0=0):
            return _finish(call(*_scalars(pose, seed, frame_number, y0),
                                *_dyn_values(tracer, arrays),
                                *_table_ops(tracer)))
    else:
        auto_ops = _auto_scene_ops(tracer) or ()

        def render_frame(pose, seed, frame_number, y0=0):
            return _finish(call(*_scalars(pose, seed, frame_number, y0),
                                *auto_ops, *_table_ops(tracer)))

    return render_frame
