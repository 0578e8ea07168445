"""Offline batched rendering: temporal accumulation as one compiled
``lax.scan`` over frames.

The interactive loop drives one compiled step per frame from Python
(runtime/engine.py) because input arrives between frames. Offline — golden
images, benchmarks, the "100-frame temporal accumulation" config —
has no input, so the whole frame sequence compiles into a single XLA
program: zero per-frame dispatch overhead and no host round-trips until the
final image. The per-frame math is the same render path; frame_number runs
0..n-1 so accumulation reproduces shader.wgsl:612-620 exactly.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import scene as scene_mod
from ..ops import denoise as dn
from ..ops import tonemap as tm
from ..ops.vecmath import V3
from .state import FrameOutput, FrameState, init_state, make_render_step


def _finalize(state: FrameState, last_frame, full_color: bool,
              denoise: float, denoise_passes: int,
              tonemap="reference", exposure: float = 0.0):
    """Tonemap a final accumulation the way the per-frame step would have
    on its LAST frame: optional à-trous denoise (ops/denoise.py, guided by
    the last frame's variance/samples planes at that frame number), then
    the display transform (--tonemap/--exposure; defaults = the reference
    tonemap). Keeps every scan/chunk path bit-identical to per-frame
    driving under the display flags."""
    acc_v = V3(state.acc[0], state.acc[1], state.acc[2])
    if denoise > 0.0:
        acc_v = dn.denoise_acc(acc_v, state.variance, state.samples,
                               last_frame, denoise, denoise_passes)
    mode = tm.parse_mode(tonemap)
    scale = 2.0 ** float(exposure)
    if full_color:
        rgb = tm.tonemap_fullcolor(acc_v, mode, scale)
        glyphs = jnp.zeros(rgb.shape[:2], jnp.uint8)
    else:
        rgb, glyphs = tm.tonemap_ascii(acc_v, mode, scale)
    return rgb, glyphs


def make_chunk_renderer(
    scene: scene_mod.Scene,
    k: int,
    full_color: bool = True,
    backend: str = "auto",
    interpret: bool = False,
    accel: str = "auto",
    transport: str = None,
    unbiased: bool = False,
    denoise: float = 0.0,
    denoise_passes: int = 3,
    tonemap="reference",
    exposure: float = 0.0,
):
    """k accumulation frames as ONE compiled dispatch: a ``lax.scan`` over
    the render step, tonemapping once from the final accumulation.

    This is the headless loop's middle ground between per-frame dispatch
    (interactive: input arrives between frames) and the whole-sequence scan
    (offline: zero dispatches, but the frame count bakes into the program).
    Small frames are dispatch-overhead-bound — one ~1-2 ms device program
    per ~0.3 ms of compute — so folding k=8 frames per dispatch recovers
    most of the scan path's throughput while keeping the host loop (noise
    checks, progress, state fetches) between chunks.

    Returns ``chunk(state, pose, seeds_k, frame0) -> (FrameOutput,
    rays_per_frame)``: the FrameOutput is the post-chunk state + final
    tonemapped frame with ``rays`` of the LAST frame (matching what the
    per-frame driving loop would display); ``rays_per_frame`` is the (k,)
    per-frame ray-count vector (benchmarks sum it over timed frames).
    Accumulation replicates frame_number frame0..frame0+k-1 exactly, so a
    chunked run is bit-identical to k per-frame steps on the same seeds.
    """
    step = make_render_step(scene, full_color=full_color, backend=backend,
                            interpret=interpret,
                            jit=False, accel=accel, transport=transport,
                            unbiased=unbiased)

    def chunk(state: FrameState, pose, seeds, frame0=jnp.int32(0)):
        def body(state, inp):
            seed, frame_number = inp
            out = step(state, pose, seed, frame_number)
            return out.state, out.rays

        frames = jnp.asarray(frame0, jnp.int32) + jnp.arange(
            k, dtype=jnp.int32
        )
        state, rays = jax.lax.scan(body, state, (jnp.asarray(seeds), frames))

        rgb, glyphs = _finalize(state, frames[-1], full_color,
                                denoise, denoise_passes, tonemap, exposure)
        out = FrameOutput(state=state, rgb=rgb, glyphs=glyphs, rays=rays[-1])
        return out, rays

    return jax.jit(chunk, donate_argnums=(0,))


def make_noise_scan_renderer(
    scene: scene_mod.Scene,
    n_frames: int,
    threshold: float,
    chunk: int = 8,
    full_color: bool = True,
    backend: str = "auto",
    interpret: bool = False,
    accel: str = "auto",
    transport: str = None,
    denoise: float = 0.0,
    denoise_passes: int = 3,
    tonemap="reference",
    exposure: float = 0.0,
):
    """``--until-noise`` composed with ``--scan``: a ``lax.while_loop``
    over chunk-of-frames scans, entirely on device.

    Each while iteration scans `chunk` accumulation frames, then the
    condition re-checks the convergence scalar — mean per-pixel sample
    variance over total samples accumulated (the same estimate
    Engine.run_headless computes between frames) — so the stop is
    chunk-granular but the whole run stays ONE XLA program with zero host
    round-trips. `n_frames` caps the run exactly; `chunk` is clamped to a
    divisor-friendly size (8/4/2/1) so the cap is always respected.

    Returns ``render(state0, pose, seeds, frame0=0) -> (state, rgb,
    glyphs, rays_total, frames_done)`` with ``seeds`` a (n_frames,) u32
    array; ``frames_done`` (i32 scalar) is the number of frames actually
    rendered.
    """
    while chunk > 1 and n_frames % chunk:
        chunk //= 2
    n_chunks = n_frames // chunk
    step = make_render_step(scene, full_color=full_color, backend=backend,
                            interpret=interpret,
                            jit=False, accel=accel, transport=transport)
    thr = float(threshold)

    def render(state: FrameState, pose, seeds, frame0=jnp.int32(0)):
        seeds_c = jnp.asarray(seeds).reshape(n_chunks, chunk)
        frame0 = jnp.asarray(frame0, jnp.int32)

        def noise_of(state, frames_done):
            var_mean = jnp.mean(state.variance)
            spp_mean = jnp.mean(state.samples)
            total = spp_mean * frames_done.astype(jnp.float32)
            return var_mean / jnp.maximum(total, 1e-9)

        def cond(carry):
            state, ci, _rays = carry
            done = frame0 + ci * chunk
            converged = (ci > 0) & (noise_of(state, done) < thr)
            return (ci < n_chunks) & ~converged

        def body(carry):
            state, ci, rays = carry

            def scan_body(st, inp):
                seed, frame_number = inp
                out = step(st, pose, seed, frame_number)
                return out.state, out.rays

            frames = frame0 + ci * chunk + jnp.arange(chunk,
                                                      dtype=jnp.int32)
            state, rays_k = jax.lax.scan(
                scan_body, state, (seeds_c[ci], frames)
            )
            return state, ci + 1, rays + jnp.sum(rays_k)

        state, ci, rays = jax.lax.while_loop(
            cond, body, (state, jnp.int32(0), jnp.float32(0.0))
        )
        rgb, glyphs = _finalize(state, frame0 + ci * chunk - 1, full_color,
                                denoise, denoise_passes, tonemap, exposure)
        return state, rgb, glyphs, rays, ci * chunk

    return jax.jit(render, donate_argnums=(0,))


def make_scan_renderer(
    scene: scene_mod.Scene,
    n_frames: int,
    full_color: bool = True,
    backend: str = "auto",
    interpret: bool = False,
    accel: str = "auto",
    transport: str = None,
    denoise: float = 0.0,
    denoise_passes: int = 3,
    tonemap="reference",
    exposure: float = 0.0,
):
    """Build `render(state0, pose, seeds, frame0=0) -> (state, rgb, glyphs,
    rays)`.

    `seeds` is a (n_frames,) uint32 array (one per frame, like the host
    reseeding at lib.rs:423). Accumulation runs frame_number frame0 ..
    frame0+n_frames-1; frame0=0 starts with a reset, frame0>0 continues a
    restored accumulation (--load-state resume).
    """
    chunk = make_chunk_renderer(scene, n_frames, full_color=full_color,
                                backend=backend, accel=accel,
                                interpret=interpret,
                                transport=transport, denoise=denoise,
                                denoise_passes=denoise_passes,
                                tonemap=tonemap, exposure=exposure)

    def render(state: FrameState, pose, seeds, frame0=jnp.int32(0)):
        out, rays = chunk(state, pose, seeds, frame0)
        return out.state, out.rgb, out.glyphs, jnp.sum(rays)

    return render


def make_orbit_scan_renderer(
    scene: scene_mod.Scene,
    n_poses: int,
    frames_per_pose: int,
    full_color: bool = True,
    backend: str = "auto",
    interpret: bool = False,
    accel: str = "auto",
    transport: Optional[str] = None,
    denoise: float = 0.0,
    denoise_passes: int = 3,
    tonemap="reference",
    exposure: float = 0.0,
):
    """The whole turntable orbit as ONE compiled XLA program: an outer
    ``lax.scan`` over camera poses, each scan step running
    ``frames_per_pose`` accumulation frames in an inner ``fori_loop``
    (frame_number restarts at 0 per pose, so the alpha=1 overwrite resets
    accumulation exactly like a camera move, shader.wgsl:612-613 /
    lib.rs:409-424). Zero per-frame AND per-pose dispatch.

    Returns ``render(poses, seeds) -> (rgb u8 [n_poses, H, W, 3],
    glyphs u8 [n_poses, H, W], rays_total)`` with ``poses`` (n_poses, 16)
    and ``seeds`` (n_poses, frames_per_pose) u32.
    """
    step = make_render_step(scene, full_color=full_color, backend=backend,
                            interpret=interpret,
                            jit=False, accel=accel, transport=transport)

    def render(poses, seeds):
        state0 = init_state(scene)

        def pose_body(carry, inp):
            rays_acc = carry
            pose, pose_seeds = inp

            def frame_body(f, c):
                state, rays = c
                out = step(state, pose, pose_seeds[f], jnp.int32(f))
                return (out.state, rays + out.rays)

            state, rays_acc = jax.lax.fori_loop(
                0, frames_per_pose, frame_body, (state0, rays_acc)
            )
            rgb, glyphs = _finalize(state, jnp.int32(frames_per_pose - 1),
                                    full_color, denoise, denoise_passes,
                                    tonemap, exposure)
            return rays_acc, (rgb, glyphs)

        rays, (rgbs, glyphss) = jax.lax.scan(
            pose_body, jnp.float32(0.0), (poses, seeds)
        )
        return rgbs, glyphss, rays

    return jax.jit(render)


def make_animation_scan_renderer(
    scene: scene_mod.Scene,
    n_frames: int,
    full_color: bool = True,
    backend: str = "auto",
    interpret: bool = False,
    transport: Optional[str] = None,
    animated=None,
    denoise: float = 0.0,
    denoise_passes: int = 3,
    tonemap="reference",
    exposure: float = 0.0,
):
    """A whole ANIMATION as one compiled XLA program: ``lax.scan`` over
    per-frame geometry/material arrays (the ops.dynamic.pack_scene layout,
    stacked to [n_frames, ...] leaves) rendered through the dynamic-scene
    step. Every frame is fresh (frame_number 0 — moving geometry must not
    accumulate); the scene values are scanned INPUTS, so the one program
    serves any animation of the same topology.

    Returns ``render(pose, arrays_seq, seeds) -> (rgb u8 [n, H, W, 3],
    glyphs u8 [n, H, W], rays_total)``.
    """
    step = make_render_step(scene, full_color=full_color, backend=backend,
                            interpret=interpret,
                            jit=False, dynamic=True, transport=transport,
                            animated=animated, denoise=denoise,
                            denoise_passes=denoise_passes,
                            tonemap=tonemap, exposure=exposure)

    def render(pose, arrays_seq, seeds):
        state0 = init_state(scene)

        def body(rays_acc, inp):
            arrays, seed = inp
            out = step(state0, pose, seed, jnp.int32(0), arrays)
            return rays_acc + out.rays, (out.rgb, out.glyphs)

        rays, (rgbs, glyphss) = jax.lax.scan(
            body, jnp.float32(0.0), (arrays_seq, seeds)
        )
        return rgbs, glyphss, rays

    return jax.jit(render)


def render_accumulated(
    scene: scene_mod.Scene,
    pose,
    n_frames: int,
    seed: Optional[int] = None,
    full_color: bool = True,
    backend: str = "auto",
    interpret: bool = False,
    transport: Optional[str] = None,
):
    """One-call offline render: n accumulated frames, returns host arrays
    (rgb u8, glyphs u8, rays)."""
    rng = np.random.RandomState(seed)
    seeds = (
        rng.randint(0, 2**32, size=n_frames, dtype=np.uint64)
        + np.arange(n_frames, dtype=np.uint64)
    ).astype(np.uint32)
    render = make_scan_renderer(scene, n_frames, full_color, backend,
                                interpret=interpret,
                                transport=transport)
    state, rgb, glyphs, rays = render(init_state(scene), pose, jnp.asarray(seeds))
    rgb, glyphs, rays = jax.device_get((rgb, glyphs, rays))
    return state, rgb, glyphs, float(rays)
