"""Frame state and the jit-stable render step.

The reference's device buffers (accumulation, variance — src/lib.rs:270-284)
become an explicit :class:`FrameState` pytree threaded through a pure
``render_step`` and *donated* on every call, so XLA updates accumulation in
place. The step is jit-compiled once per (scene, mode, backend); between
frames only ``(camera pose, seed, frame_number)`` change — the invariant of
SURVEY.md §3.5 — so interactive camera movement never retraces.

Temporal accumulation replicates shader.wgsl:612-620: a running mean with
alpha = 1/(frame_number+1), overwritten when frame_number == 0 (which the
host sets on camera movement, lib.rs:409-424).

Because state is explicit, checkpoint/resume falls out for free
(utils/statefile.py) — a capability superset over the reference, which can
never persist its accumulation (SURVEY.md §5.4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models import scene as scene_mod
from ..ops import tonemap as tm
from ..ops import tracer as tracer_mod
from ..ops.vecmath import V3


class FrameState(NamedTuple):
    """Device-resident per-frame state. `acc` is [3, H, W] (SoA color
    planes); `variance` / `samples` are the reference's write-only variance
    buffer (shader.wgsl:608), actually exposed here (debug heat map)."""

    acc: jnp.ndarray  # [3, H, W] f32 running-mean radiance
    variance: jnp.ndarray  # [H, W] f32
    samples: jnp.ndarray  # [H, W] f32 samples taken last frame


class FrameOutput(NamedTuple):
    state: FrameState
    rgb: jnp.ndarray  # [H, W, 3] u8
    glyphs: jnp.ndarray  # [H, W] u8 (zeros in full-color mode)
    rays: jnp.ndarray  # f32 scalar: traversal sweeps this frame
    # f32 scalar: measured sweep-weighted lane occupancy in [0, 1] — owed
    # sweeps (rays) over executed lane-iteration sweeps. The kernel
    # surfaces it (executed iterations per block), as does the sharded
    # mesh step (per-shard capacities psum-merged) and the jnp oracle
    # (measured lockstep trips, tracer.render_frame with_occ). -1 only
    # where a caller bypasses make_render_step with a bare 4-tuple
    # render_frame.
    occupancy: jnp.ndarray = None


def init_state(scene: scene_mod.Scene) -> FrameState:
    h, w = scene.height, scene.width
    return FrameState(
        acc=jnp.zeros((3, h, w), jnp.float32),
        variance=jnp.zeros((h, w), jnp.float32),
        samples=jnp.zeros((h, w), jnp.float32),
    )


def resolve_backend(backend: str, platform: str = None) -> str:
    """'auto' -> 'pallas' (the megakernel) on a GPU, else 'jnp' (the XLA
    oracle). Explicit choices pass through."""
    if backend != "auto":
        return backend
    platform = platform or jax.default_backend()
    return "pallas" if platform == "gpu" else "jnp"


def make_render_step(
    scene: scene_mod.Scene,
    full_color: bool = True,
    backend: str = "auto",
    jit: bool = True,
    unbiased: bool = False,
    transport: str = None,
    accel: str = "auto",
    dynamic: bool = False,
    animated=None,
    denoise: float = 0.0,
    denoise_passes: int = 3,
    tonemap="reference",
    exposure: float = 0.0,
    interpret: bool = False,
):
    """Build `step(state, pose16, seed, frame_number) -> FrameOutput`.

    backend: 'jnp' (the oracle — runs on any JAX backend), 'pallas' (the
    GPU megakernel, ops/pallas_kernel.py), or 'auto' (resolve_backend).
    interpret: run the pallas kernel in the Pallas interpreter (tests);
    without it, backend='pallas' off a GPU is refused.
    accel: traversal — 'baked' brute-force sweep, 'array' SoA sweep,
    'grid' block-culled (ops/accel.py), 'gathered' per-lane grid walk
    (ops/gathered.py), 'auto' by primitive count.
    dynamic: the step gains a trailing `arrays` argument (the
    ops.dynamic.pack_scene layout) and reads geometry/materials from it at
    runtime — the --animate mode; values change per frame, nothing
    retraces.
    animated: with dynamic, the key subset that actually varies — the rest
    folds back to baked constants (models.animate.ANIMATOR_KEYS for the
    built-in animators; None = everything runtime).
    denoise: > 0 runs the edge-aware à-trous reconstruction filter
    (ops/denoise.py) over the accumulated radiance before tonemapping —
    a pure post-process (estimator, RNG chains, checkpoints untouched).
    Statically gated: 0.0 (the default) compiles the exact unfiltered
    program.
    tonemap / exposure: display transform (ops/tonemap.py parse_mode
    specs) and pre-tonemap exposure in STOPS (scale 2**exposure).
    Statically gated: the defaults compile the exact reference tonemap.
    """
    backend = resolve_backend(backend)
    tm_mode = tm.parse_mode(tonemap)
    tm_scale = 2.0 ** float(exposure)

    if backend == "jnp":
        tracer = tracer_mod.PathTracer(scene, unbiased=unbiased,
                                       transport=transport, accel=accel,
                                       dynamic=dynamic, dyn_animated=animated)
        _rf = (tracer.render_frame_dynamic if dynamic
               else tracer.render_frame)

        def render_frame(*args, _rf=_rf):
            # The oracle measures occupancy too (with_occ appends it) —
            # same owed/executed sweep accounting as the Pallas paths.
            return _rf(*args, with_occ=True)
    elif backend == "pallas":
        from ..ops import pallas_kernel

        render_frame = pallas_kernel.make_render_frame(
            scene, unbiased=unbiased, transport=transport, accel=accel,
            dynamic=dynamic, animated=animated, interpret=interpret)
    else:
        raise ValueError(f"unknown backend {backend!r}")

    def step(state: FrameState, pose, seed, frame_number,
             arrays=None) -> FrameOutput:
        args = (pose, seed, frame_number, arrays) if dynamic else (
            pose, seed, frame_number)
        res = render_frame(*args)
        # Every render_frame built above appends the measured occupancy;
        # the 4-tuple branch covers externally-supplied bare oracles.
        if len(res) == 5:
            current, variance, samples, rays, occ = res
        else:
            current, variance, samples, rays = res
            occ = jnp.float32(-1.0)

        # Temporal accumulation (shader.wgsl:612-620).
        fn = jnp.asarray(frame_number, jnp.float32)
        alpha = jnp.where(fn == 0.0, 1.0, 1.0 / (fn + 1.0))
        cur = jnp.stack([current.x, current.y, current.z])
        acc = state.acc * (1.0 - alpha) + cur * alpha

        acc_v = V3(acc[0], acc[1], acc[2])
        if denoise > 0.0:
            from ..ops import denoise as dn

            acc_v = dn.denoise_acc(acc_v, variance, samples, frame_number,
                                   denoise, denoise_passes)
        if full_color:
            rgb = tm.tonemap_fullcolor(acc_v, tm_mode, tm_scale)
            glyphs = jnp.zeros(rgb.shape[:2], jnp.uint8)
        else:
            rgb, glyphs = tm.tonemap_ascii(acc_v, tm_mode, tm_scale)

        return FrameOutput(
            state=FrameState(acc=acc, variance=variance, samples=samples),
            rgb=rgb,
            glyphs=glyphs,
            rays=rays,
            occupancy=occ,
        )

    if jit:
        step = jax.jit(step, donate_argnums=(0,))
    step.backend = backend
    return step
