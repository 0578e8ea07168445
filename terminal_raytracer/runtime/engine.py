"""The frame-loop engine — the reference's `run()` re-designed around an
async device pipeline.

The reference's loop is fully synchronous: dispatch, block on readback,
encode, print (reference: src/lib.rs:386-565, blocking map_async+poll at
lib.rs:468-472). Here the compiled render step for frame k+1 is dispatched
*before* frame k's pixels are fetched and blitted, so host encode/IO overlap
device compute (JAX dispatch is async; `jax.device_get` of the previous
frame is the only sync point). One frame of display latency, bought back as
throughput — `pipeline=False` restores the reference's ordering.

Loop semantics match lib.rs:386-565: 1 ms input poll; WASD/arrows mutate the
camera and reset accumulation (frame_number=0); rendering stops at
`frames_to_accumulate` and idles at 10 ms; ESC exits. Extensions: 'v'
toggles the variance heat-map debug view (completing the reference's
write-only variance channel, SURVEY.md §5.5), 'p' dumps a screenshot.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models import Camera, scene as scene_mod
from ..ops import tonemap as tm
from .blit import Blitter
from .state import init_state, make_render_step
from .terminal import TerminalSession
from .timing import FrameTimers

IDLE_SLEEP = 0.010  # accumulation finished (lib.rs:562-563)


def _parse_shard(spec: str):
    """--shard spec -> (n_px, n_sp). Accepted forms: "N" (N-way pixel-row
    data parallelism), "px:N", "sp:N", "px:N,sp:M" (axes in either order).
    See parallel/mesh.py for the axis semantics."""
    seen = {}
    try:
        parts = [p.strip() for p in str(spec).split(",")]
        for part in parts:
            if ":" in part:
                axis, _, n = part.partition(":")
                if axis not in ("px", "sp"):
                    raise ValueError(axis)
                if axis in seen:
                    raise ValueError(f"duplicate {axis}")
                seen[axis] = int(n)
            else:
                # Bare N = N-way pixel-row DP; only valid as the whole spec
                # (mixing it with axis forms would silently override).
                if len(parts) > 1:
                    raise ValueError("bare N must stand alone")
                seen["px"] = int(part)
    except (ValueError, TypeError):
        raise ValueError(
            f"bad --shard spec {spec!r}; expected N, px:N, sp:N, or "
            f"px:N,sp:M (each axis at most once)"
        ) from None
    n_px = seen.get("px", 1)
    n_sp = seen.get("sp", 1)
    if n_px < 1 or n_sp < 1 or n_px * n_sp < 2:
        raise ValueError(
            f"--shard {spec!r} must name at least 2 devices (px * sp >= 2)"
        )
    return n_px, n_sp


class Engine:
    def __init__(
        self,
        scene: scene_mod.Scene,
        full_color: bool = False,
        backend: str = "auto",
        threads: int = 0,
        verbose: bool = False,
        deterministic: Optional[int] = None,
        pipeline: bool = True,
        camera: Optional[Camera] = None,
        unbiased: bool = False,
        transport: str = None,
        accel: str = "auto",
        animate: str = None,
        shard: str = None,
        denoise: float = 0.0,
        denoise_passes: int = 3,
        tonemap="reference",
        exposure: float = 0.0,
    ):
        self.scene = scene
        self.full_color = full_color
        self.verbose = verbose
        self.pipeline = pipeline
        self.camera = camera if camera is not None else Camera()
        # --shard: multi-chip rendering (parallel/mesh.py shard_map over a
        # ('px','sp') device mesh). Spec: "N" (N-way pixel-row DP),
        # "px:N", "sp:N", or "px:N,sp:M". The sharded step replaces the
        # single-chip step one-for-one (same call shape/FrameOutput).
        self.shard = _parse_shard(shard) if shard else None
        if self.shard is not None:
            if unbiased:
                raise ValueError("--shard does not support --unbiased")
            if accel != "auto":
                raise ValueError("--shard picks the traversal itself; "
                                 "drop --accel")
        # --animate: geometry/materials stream through the compiled step as
        # runtime arrays (ops/dynamic.py); every frame is rendered fresh
        # (frame_number pinned to 0 — temporal accumulation would smear
        # moving geometry), and the animation clock advances per render.
        self.animate = animate
        animated_keys = None
        if animate is not None:
            from ..models.animate import ANIMATOR_KEYS, ANIMATORS
            from ..ops.dynamic import pack_scene

            if animate not in ANIMATORS:
                raise ValueError(
                    f"unknown animator {animate!r}; have "
                    f"{sorted(ANIMATORS)}"
                )
            self._animator = ANIMATORS[animate]
            self._arrays0 = pack_scene(scene)
            self._anim_t = 0
            # Only this animator's keys stream at runtime; the rest of the
            # scene folds back to baked constants (near-static-speed
            # animation for e.g. orbit's static planes).
            animated_keys = ANIMATOR_KEYS.get(animate)
        if self.shard is not None:
            from ..parallel import make_mesh, make_sharded_render_step

            n_px, n_sp = self.shard
            n_dev = len(jax.devices())
            if n_px * n_sp > n_dev:
                raise ValueError(
                    f"shard px:{n_px},sp:{n_sp} needs {n_px * n_sp} devices, "
                    f"have {n_dev}"
                )
            mesh = make_mesh(n_px, n_sp)
            self.step, sharded_init = make_sharded_render_step(
                scene, mesh, full_color=full_color, backend=backend,
                transport=transport, dynamic=animate is not None,
                animated=animated_keys, denoise=denoise,
                denoise_passes=denoise_passes, tonemap=tonemap,
                exposure=exposure,
            )
            self.state = sharded_init()
        else:
            self.step = make_render_step(scene, full_color=full_color,
                                         backend=backend, unbiased=unbiased,
                                         transport=transport, accel=accel,
                                         dynamic=animate is not None,
                                         animated=animated_keys,
                                         denoise=denoise,
                                         denoise_passes=denoise_passes,
                                         tonemap=tonemap,
                                         exposure=exposure)
            self.state = init_state(scene)
        # The backend the step actually runs ('auto' resolved), named with
        # the device platform on the status line and under --verbose.
        backend = self.step.backend
        self.device_label = f"{jax.devices()[0].platform}/{backend}"
        # --denoise/--tonemap/--exposure: kept for the screenshot path
        # ('p' re-finalizes the accumulation the way the step displays it).
        self.denoise = float(denoise)
        self.denoise_passes = int(denoise_passes)
        self.tonemap = tonemap
        self.exposure = float(exposure)
        # Step-construction options, kept for the lazily-built chunked
        # headless renderers (run_headless folds k frames per dispatch).
        self._step_opts = dict(full_color=full_color, backend=backend,
                               unbiased=unbiased, transport=transport,
                               accel=accel, denoise=denoise,
                               denoise_passes=denoise_passes,
                               tonemap=tonemap, exposure=exposure)
        self._chunk_renderers = {}
        self.blitter = Blitter(scene.height, scene.width, full_color, threads)
        # The variance heat map is always drawn as truecolor blocks.
        self._fc_blitter = (
            self.blitter
            if full_color
            else Blitter(scene.height, scene.width, True, threads)
        )
        self.timers = FrameTimers()
        self.frame_count = 0
        self.variance_view = False
        self._shot_idx = 0
        self._rng = np.random.RandomState(deterministic)
        self._deterministic = deterministic is not None
        # Tiny jitted postprocessors for the debug view / stats scalars.
        self._heatmap = jax.jit(tm.variance_heatmap)
        self._mean = jax.jit(jnp.mean)
        if verbose:
            # device + runtime info (the reference prints workgroup limits
            # and rayon thread count under --verbose, lib.rs:263-267,
            # main.rs:33-35)
            dev = jax.devices()[0]
            print(
                f"device: {dev.platform} {getattr(dev, 'device_kind', '')} | "
                f"backend={backend} | blitter="
                f"{'native' if self.blitter.native else 'python'} "
                f"({self.blitter.threads} threads) | "
                f"{scene.width}x{scene.height} spp={scene.samples_per_pixel} "
                f"depth={scene.max_depth} | "
                f"{scene.primitive_count} primitives, {len(scene.lights)} lights",
                file=sys.stderr,
            )

    # ------------------------------------------------------------------

    def _seed(self) -> np.uint32:
        # rand::random::<u32>() + frame_count (lib.rs:423), wrapping.
        return np.uint32(
            (self._rng.randint(0, 2**32, dtype=np.uint64) + self.frame_count)
            & 0xFFFFFFFF
        )

    def render_one(self, frame_number: int):
        """Dispatch one compiled step (async) and advance state."""
        if self.animate is not None:
            arrays = self._animator(self._arrays0, self._anim_t)
            self._anim_t += 1
            out = self.step(
                self.state, self.camera.pose(), self._seed(), np.int32(0),
                arrays,
            )
            self.state = out.state
            return out
        out = self.step(
            self.state, self.camera.pose(), self._seed(), np.int32(frame_number)
        )
        self.state = out.state
        self.frame_count += 1
        return out

    def _fetch(self, out):
        """Sync point: previous frame's device->host transfer."""
        heatmap = self.variance_view
        if heatmap:
            rgb = self._heatmap(out.state.variance)
            glyphs = None
        else:
            rgb = out.rgb
            glyphs = None if self.full_color else out.glyphs
        occ = getattr(out, "occupancy", None)
        rgb, glyphs, rays, mean_samples, occ = jax.device_get(
            (rgb, glyphs, out.rays, self._mean(out.state.samples), occ)
        )
        self._fetched_at = time.perf_counter()  # pairs rays with its interval
        self._last_occ = -1.0 if occ is None else float(occ)
        return rgb, glyphs, rays, mean_samples, heatmap

    # ------------------------------------------------------------------

    def run_interactive(self):
        scene = self.scene
        # A restored state (--load-state) continues refinement from its
        # saved frame counter; only a fresh engine starts with a reset.
        cam_moved = self.frame_count == 0
        pending = None  # dispatched-but-not-displayed FrameOutput
        with TerminalSession() as term:
            while True:
                self.timers.start_frame()
                key = term.poll_key(0.001)
                if key == "esc":
                    break
                if key == "v":
                    self.variance_view = not self.variance_view
                if key == "p":
                    self._screenshot()
                moved = self.camera.apply_key(key) if key else False
                if moved:
                    cam_moved = True
                    self.frame_count = 0
                    pending = None  # stale frame: don't display pre-move pixels

                if self.frame_count < scene.frames_to_accumulate:
                    out = self.render_one(0 if cam_moved else self.frame_count)
                    cam_moved = False
                    if not self.pipeline:
                        with self.timers.phase("gpu"):
                            fetched = self._fetch(out)
                        self._display(term, fetched)
                        continue
                    if pending is not None:
                        # Fetching frame k-1 is the device sync point — it
                        # overlaps with frame k's compute just dispatched.
                        with self.timers.phase("gpu"):
                            fetched = self._fetch(pending)
                        self._display(term, fetched)
                    pending = out
                else:
                    if pending is not None:
                        self._display(term, self._fetch(pending))
                        pending = None
                    time.sleep(IDLE_SLEEP)
        print("Exiting.")

    def _screenshot(self):
        """'p' key: dump the current accumulation as a PNG in the cwd."""
        from ..ops.vecmath import V3
        from ..utils import imageio

        acc = self.state.acc
        acc_v = V3(acc[0], acc[1], acc[2])
        if self.denoise > 0.0:
            # Re-finalize the way the step displays it (ops/denoise.py);
            # the checkpointed accumulation itself stays raw.
            from ..ops import denoise as dn

            acc_v = dn.denoise_acc(acc_v, self.state.variance,
                                   self.state.samples,
                                   max(self.frame_count - 1, 0),
                                   self.denoise, self.denoise_passes)
        rgb = jax.device_get(tm.tonemap_fullcolor(
            acc_v, tm.parse_mode(self.tonemap), 2.0 ** self.exposure))
        path = f"screenshot_{self._shot_idx}.png"
        self._shot_idx += 1
        imageio.write_png(path, np.asarray(rgb))

    def _display(self, term, fetched):
        rgb, glyphs, rays, mean_samples, heatmap = fetched
        with self.timers.phase("cpu"):
            blitter = self._fc_blitter if heatmap else self.blitter
            payload = blitter.encode(
                np.asarray(rgb), None if glyphs is None else np.asarray(glyphs)
            )
        mray = self.timers.update_ray_rate(
            float(rays), fetched_at=getattr(self, "_fetched_at", None)
        ) / 1e6
        status = self.timers.status_line(
            self.frame_count,
            self.scene.frames_to_accumulate,
            mray_s=mray,
            samples=float(mean_samples),
            occupancy=getattr(self, "_last_occ", -1.0),
            device=self.device_label,
        )
        with self.timers.phase("io"):
            term.write_frame(payload, status, self.scene.height)

    # ------------------------------------------------------------------

    HEADLESS_CHUNK = 8  # accumulation frames folded into one dispatch

    def run_headless(self, n_frames: int, until_noise: float = None,
                     chunk: "int | str" = "auto"):
        """Render n accumulated frames without a terminal; returns the final
        fetched (rgb, glyphs, rays, mean_samples). Frame numbering continues
        from self.frame_count so a --load-state resume keeps accumulating
        instead of overwriting the restored buffer at alpha=1.

        `chunk`: accumulation frames folded into ONE compiled dispatch
        (lax.scan over the step — offline.make_chunk_renderer). Small
        frames are dispatch-overhead-bound, so chaining k=8 recovers most
        of the whole-sequence scan path's throughput; results are
        bit-identical to per-frame driving on the same seed sequence.
        'auto' = 8, dropping to per-frame when a per-frame host decision is
        needed (`until_noise` checks noise between frames; `--animate`
        evaluates the animator per frame).

        `until_noise`: convergence stop (extension — the reference only
        counts frames): stop as soon as the estimated noise of the
        accumulated mean — mean per-pixel sample variance divided by total
        samples accumulated — drops below this, or after n_frames,
        whichever first. Checking syncs a scalar per frame, which headless
        mode can afford."""
        if n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {n_frames}")
        if until_noise is not None and self.animate is not None:
            # Animated frames render fresh (frame_count stays 0), so the
            # accumulated-noise estimate never advances — the stop would
            # silently never fire. The CLI rejects the combination too;
            # guard the library API the same way.
            raise ValueError("until_noise is incompatible with an animated "
                             "engine: animation never accumulates, so the "
                             "noise estimate cannot converge")
        if chunk == "auto":
            chunk = (1 if (self.animate is not None or
                           until_noise is not None or
                           self.shard is not None)
                     else min(self.HEADLESS_CHUNK, n_frames))
        chunk = max(int(chunk), 1)
        if chunk > 1 and self.shard is not None:
            # The chunk renderer rebuilds a single-chip step; folding
            # frames under shard_map is a lax.scan over the sharded step —
            # not wired up. Per-frame driving keeps the semantics obvious.
            raise ValueError("explicit chunking is not supported with "
                             "--shard (per-frame driving only)")

        if chunk > 1 and self.animate is None:
            out = None
            remaining = n_frames
            while remaining > 0:
                k = min(chunk, remaining)
                render = self._chunk_renderers.get(k)
                if render is None:
                    from .offline import make_chunk_renderer

                    render = make_chunk_renderer(self.scene, k,
                                                 **self._step_opts)
                    self._chunk_renderers[k] = render
                frame0 = self.frame_count
                # Mirror the per-frame loop's (seed, frame) pairs exactly:
                # one host RNG draw per frame, offset by its frame index.
                seeds = []
                for _ in range(k):
                    seeds.append(self._seed())
                    self.frame_count += 1
                out, _rays_k = render(self.state, self.camera.pose(),
                                      np.asarray(seeds, np.uint32),
                                      np.int32(frame0))
                self.state = out.state
                remaining -= k
                if until_noise is not None:
                    # Explicit chunk + convergence stop: check between
                    # chunks (chunk-granular, like the --scan noise loop).
                    if self._noise_estimate(out.state) < until_noise:
                        break
            return self._fetch(out)

        out = None
        for _ in range(n_frames):
            out = self.render_one(self.frame_count)
            if until_noise is not None:
                if self._noise_estimate(out.state) < until_noise:
                    break
        return self._fetch(out)

    def _noise_estimate(self, state) -> float:
        """Estimated noise of the accumulated mean: mean per-pixel sample
        variance over total samples accumulated (the same scalar the
        --scan noise loop checks on device, offline.make_noise_scan_renderer)."""
        var_mean = float(jax.device_get(self._mean(state.variance)))
        spp_mean = float(jax.device_get(self._mean(state.samples)))
        return var_mean / max(spp_mean * self.frame_count, 1e-9)
