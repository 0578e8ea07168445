"""Command-line entry point.

Reference-parity flags (reference: src/main.rs:9-20): --full-color,
--verbose, --threads N, --path FILE. Controls in the interactive viewer
(src/lib.rs:393-404): WASD move, arrows steer, ESC exits — plus extensions:
'v' toggles the variance heat map, and the flags below marked (ext).

Run: python -m terminal_raytracer [flags]
"""

from __future__ import annotations

import argparse
import sys


def _tonemap_spec(spec: str) -> str:
    """argparse type for --tonemap: validate eagerly (parse_mode raises
    ValueError -> a clean flag error), keep the raw spec string."""
    from .ops.tonemap import parse_mode

    parse_mode(spec)
    return spec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="terminal-raytracer",
        description="Terminal path tracer (JAX/XLA/Pallas).",
    )
    # --- reference-parity flags (main.rs:9-20) ---
    p.add_argument("--full-color", action="store_true",
                   help="render 24-bit truecolor block cells instead of ASCII")
    p.add_argument("--verbose", action="store_true",
                   help="print device/runtime info")
    p.add_argument("--threads", type=int, default=0,
                   help="host blitter threads (default: all cores)")
    p.add_argument("--path", metavar="FILE", default=None,
                   help="scene JSON path (default: packaged Cornell box)")
    # --- extensions ---
    p.add_argument("--scene", default=None,
                   help="(ext) packaged scene name (Cornell_Box, demo, "
                        "scene2, mesh_demo) or procedural stress:N[:seed] / "
                        "icosphere:S[:seed] / lights:L[:seed]")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "pallas", "jnp"],
                   help="(ext) compute backend (default: the Pallas "
                        "kernel on a GPU, jnp elsewhere)")
    p.add_argument("--accel", default="auto",
                   choices=["auto", "baked", "array", "grid", "gathered"],
                   help="(ext) traversal: unrolled baked sweep (fastest at "
                        "shipped scale), array-resident fori_loop sweep "
                        "(fixed code size — many-primitive scenes), the "
                        "experimental block-culled grid, or per-lane "
                        "gathered grid walks (measured slower — see "
                        "ops/gathered.py); auto picks baked/array by "
                        "primitive count")
    p.add_argument("--frames", type=int, default=None, metavar="N",
                   help="(ext) headless: render N accumulated frames and exit")
    p.add_argument("--width", type=int, default=None, help="(ext) override")
    p.add_argument("--height", type=int, default=None, help="(ext) override")
    p.add_argument("--spp", type=int, default=None,
                   help="(ext) override samples_per_pixel")
    p.add_argument("--depth", type=int, default=None,
                   help="(ext) override max_depth")
    p.add_argument("--aperture", type=float, default=None,
                   help="(ext) thin-lens radius for depth of field "
                        "(0 = pinhole, the reference's camera)")
    p.add_argument("--focus", type=float, default=None,
                   help="(ext) focus distance along the view axis "
                        "(with --aperture)")
    p.add_argument("--filter", dest="texture_filter", default=None,
                   choices=("nearest", "bilinear"),
                   help="(ext) texture magnification filter override: "
                        "'bilinear' blends the 2x2 texel neighborhood at "
                        "every image-texture/sky fetch (default: the "
                        "scene's texture_filter, or nearest)")
    p.add_argument("--sampler", default=None,
                   choices=("reference", "stratified"),
                   help="(ext) pixel-jitter sampler override: 'stratified' "
                        "places base-phase samples on a jittered sub-pixel "
                        "grid (same RNG draws, affinely remapped — "
                        "unbiased, faster-converging anti-aliasing at "
                        "edges; adaptive extras keep independent jitter). "
                        "Default: the scene's sampler, or reference")
    p.add_argument("--light-sample", dest="light_sample", default=None,
                   choices=("all", "uniform", "power"),
                   help="(ext) NEE light-sampling strategy override: 'all' "
                        "casts one shadow ray per light per bounce (the "
                        "reference's NEE loop); 'uniform'/'power' pick ONE "
                        "light per bounce (uniformly, or by emitted power) "
                        "and weight the estimate by 1/p(pick) — unbiased, "
                        "with per-bounce occlusion cost O(1) instead of "
                        "O(lights). Default: the scene's light_sample, or "
                        "all. Scenes with <= 1 light ignore it")
    p.add_argument("--denoise", type=float, default=0.0, metavar="K",
                   help="(ext) edge-aware à-trous reconstruction filter "
                        "over the accumulated radiance before tonemap "
                        "(SVGF-family spatial pass, guided by the adaptive "
                        "sampler's variance): K is the edge-stop strength "
                        "(try 0.5-2; larger = smoother). A pure display "
                        "post-process — the estimator, RNG chains and "
                        "checkpoints stay raw, and the filter fades to the "
                        "identity as accumulation converges. 0 = off")
    p.add_argument("--denoise-passes", type=int, default=3, metavar="N",
                   help="(ext) à-trous rounds (tap stride doubles each "
                        "round; default 3 = 13x13 footprint)")
    p.add_argument("--tonemap", type=_tonemap_spec, default="reference",
                   metavar="MODE",
                   help="(ext) display transform: 'reference' (the "
                        "reference's sqrt / pow-0.3 curves, default), "
                        "'aces' (Narkowicz ACES filmic fit + 1/2.2 display "
                        "gamma), or 'gamma:G' (plain 1/G power curve). "
                        "Display-only — the estimator and checkpoints "
                        "stay linear radiance")
    p.add_argument("--exposure", type=float, default=0.0, metavar="STOPS",
                   help="(ext) pre-tonemap exposure in stops (radiance x "
                        "2^STOPS); display-only, composes with --tonemap")
    p.add_argument("--fog", metavar="D[:R,G,B[:G]]", default=None,
                   help="(ext) homogeneous volumetric fog: extinction "
                        "density D per world unit, optional scattering "
                        "albedo (default 1,1,1) and Henyey-Greenstein "
                        "anisotropy G (default 0 = isotropic; real fog "
                        "~0.6-0.9 forward); e.g. --fog 0.15, "
                        "--fog 0.2:0.8,0.85,0.9, --fog 0.2:1,1,1:0.7")
    p.add_argument("--deterministic", type=int, default=None, metavar="SEED",
                   help="(ext) fixed RNG seed (reference seeds randomly)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="(ext) synchronous frame loop, like the reference")
    p.add_argument("--dump-image", metavar="FILE", default=None,
                   help="(ext) with --frames: write final frame (.ppm or .png)")
    p.add_argument("--save-state", metavar="FILE", default=None,
                   help="(ext) with --frames: checkpoint accumulation state")
    p.add_argument("--load-state", metavar="FILE", default=None,
                   help="(ext) resume from a saved state")
    p.add_argument("--no-clamp", action="store_true",
                   help="(ext) don't clamp resolution to the terminal size")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="(ext) disable the persistent XLA compilation "
                        "cache ($JAX_COMPILATION_CACHE_DIR if set, else "
                        "<checkout>/.jax_cache)")
    p.add_argument("--unbiased", action="store_true",
                   help="(ext) physically-correct direct lighting: skip "
                        "re-adding emission on NEE-sampled diffuse hits "
                        "(the reference double-counts; see PARITY.md)")
    p.add_argument("--mis", action="store_true",
                   help="(ext) multiple importance sampling: weigh NEE and "
                        "BSDF-hit emission by the balance heuristic — same "
                        "mean as --unbiased, lower variance; traces the "
                        "exact same paths (same RNG chains). Rough "
                        "(brushed) metals are weighted exactly too: the "
                        "fuzz lobe has an analytic pdf, so NEE covers "
                        "light seen via rough reflections")
    p.add_argument("--animate", choices=("orbit", "pulse", "bob"),
                   default=None,
                   help="(ext) animate the scene (geometry/emission stream "
                        "through the compiled step as runtime arrays — no "
                        "recompiles); each frame renders fresh")
    p.add_argument("--turntable", type=int, default=None, metavar="N",
                   help="(ext) with --frames: render N poses orbiting the "
                        "scene centroid (accumulating --frames frames "
                        "each) and write a numbered image sequence to "
                        "--dump-image (a %%d pattern, or _NNN is inserted "
                        "before the extension); add --scan to compile the "
                        "ENTIRE orbit as one XLA program")
    p.add_argument("--until-noise", type=float, default=None, metavar="X",
                   help="(ext) with --frames: stop early once the "
                        "estimated noise of the accumulated image (mean "
                        "sample variance / total samples) drops below X; "
                        "--frames caps the run (per pose with --turntable; "
                        "with --scan the check runs on device between "
                        "chunk-of-frames scans)")
    p.add_argument("--scan", action="store_true",
                   help="(ext) with --frames: compile the whole frame "
                        "sequence as one lax.scan program (offline mode)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="(ext) with --frames: dump a jax.profiler trace of "
                        "the render to DIR (view with TensorBoard/Perfetto)")
    p.add_argument("--shard", metavar="SPEC", default=None,
                   help="(ext) multi-chip rendering over a device mesh "
                        "(parallel/mesh.py): N = N-way pixel-row data "
                        "parallelism, or px:N / sp:N / px:N,sp:M to also "
                        "split samples with reference-exact adaptive "
                        "statistics; correct, but currently slower than "
                        "one card (PERF.md)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .models import load_scene
    from .runtime.engine import Engine
    from .runtime.terminal import terminal_size

    if args.path and args.scene:
        print("error: --path and --scene are mutually exclusive", file=sys.stderr)
        return 2
    if args.frames is not None and args.frames < 1:
        print(f"error: --frames must be >= 1 (got {args.frames})",
              file=sys.stderr)
        return 2
    if args.mis and args.unbiased:
        print("error: --mis and --unbiased are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.turntable is not None and args.frames is None:
        print("error: --turntable needs --frames N (accumulation frames "
              "per pose)", file=sys.stderr)
        return 2
    if args.animate and args.turntable is not None:
        print("error: --animate is incompatible with --turntable",
              file=sys.stderr)
        return 2
    if args.animate and args.scan and not args.dump_image:
        print("error: --animate --scan writes an image sequence; pass "
              "--dump-image (a %d pattern or a name to number)",
              file=sys.stderr)
        return 2
    if args.until_noise is not None and args.animate:
        print("error: --until-noise cannot converge under --animate "
              "(animated frames never accumulate)", file=sys.stderr)
        return 2
    if (args.until_noise is not None and args.scan
            and args.turntable is not None):
        print("error: --until-noise with --turntable needs per-pose "
              "frame driving (drop --scan)", file=sys.stderr)
        return 2
    if args.shard:
        # The offline scan/turntable compilers are single-chip programs the
        # Engine never sees; everything Engine-owned (--animate/--unbiased/
        # --accel, bad specs, device counts) is validated by Engine itself
        # and surfaces through the try/except around its construction.
        for flag, bad in (("--scan", args.scan),
                          ("--turntable", args.turntable is not None)):
            if bad:
                print(f"error: --shard is incompatible with {flag}",
                      file=sys.stderr)
                return 2
    try:
        scene = load_scene(args.path or args.scene)
        fog = None
        if args.fog is not None:
            from .models.scene import Fog

            spec = args.fog.split(":")
            density = float(spec[0])
            albedo = (1.0, 1.0, 1.0)
            if len(spec) > 1 and spec[1]:
                parts = [float(c) for c in spec[1].split(",")]
                if len(parts) != 3:
                    raise ValueError(
                        f"--fog albedo needs 3 comma-separated values, "
                        f"got {spec[1]!r}"
                    )
                albedo = tuple(parts)
            g = float(spec[2]) if len(spec) > 2 else 0.0
            fog = Fog(density=density, albedo=albedo, g=g)
        scene = scene.with_overrides(
            width=args.width, height=args.height,
            samples_per_pixel=args.spp, max_depth=args.depth,
            aperture=args.aperture, focus_distance=args.focus,
            fog=fog, texture_filter=args.texture_filter,
            sampler=args.sampler, light_sample=args.light_sample,
        )
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # Persistent XLA compilation cache (utils/cache.py): every later
    # launch of the same (scene shape, config) skips the compile. Must be
    # set before the first compile.
    import jax

    if args.no_compile_cache:
        jax.config.update("jax_enable_compilation_cache", False)
    else:
        from .utils.cache import enable_compile_cache

        enable_compile_cache()

    interactive = args.frames is None
    if interactive and not args.no_clamp:
        tw, th = terminal_size()
        scene = scene.clamp_to_terminal(tw, th)  # lib.rs:113-115
        if args.shard:
            # The sharded step needs height % n_px == 0; the terminal clamp
            # picks arbitrary heights, so round down to the nearest
            # multiple (floor 2) instead of erroring out of interactive
            # multi-chip mode.
            from .runtime.engine import _parse_shard

            try:
                n_px, _n_sp = _parse_shard(args.shard)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            h = scene.height - scene.height % n_px
            if h < n_px:
                # Terminal shorter than one row per px-shard: the smallest
                # valid height is n_px itself (one row each) — taller than
                # the terminal, but it renders; bailing out of interactive
                # mode with a divisibility error would be worse.
                h = n_px
            if h != scene.height:
                scene = scene.with_overrides(height=h)

    if args.full_color:
        print("outputting with █ characters")  # main.rs:27-31
    else:
        print("outputting with ASCII characters")

    try:
        engine = Engine(
            scene,
            full_color=args.full_color,
            backend=args.backend,
            threads=args.threads,
            verbose=args.verbose,
            deterministic=args.deterministic,
            pipeline=not args.no_pipeline,
            unbiased=args.unbiased,
            transport="mis" if args.mis else None,
            accel=args.accel,
            animate=args.animate,
            shard=args.shard,
            denoise=args.denoise,
            denoise_passes=args.denoise_passes,
            tonemap=args.tonemap,
            exposure=args.exposure,
        )
    except ValueError as e:
        # e.g. a bad --shard spec, or more shards than devices
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.load_state:
        from .utils.statefile import load_state

        try:
            engine.state, engine.frame_count, engine.camera = load_state(
                args.load_state, expect_shape=(scene.height, scene.width)
            )
        except (ValueError, OSError, KeyError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    if interactive:
        if not sys.stdin.isatty():
            print("error: interactive mode needs a tty (use --frames N for "
                  "headless rendering)", file=sys.stderr)
            return 2
        engine.run_interactive()
        return 0

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)

    if args.turntable is not None:
        if args.turntable < 1:
            print(f"error: --turntable must be >= 1 (got {args.turntable})",
                  file=sys.stderr)
            return 2
        if not args.dump_image:
            print("error: --turntable needs --dump-image (a %d pattern or "
                  "a name to number)", file=sys.stderr)
            return 2
        err = _check_sequence_pattern(args.dump_image)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        with profile_ctx:
            paths = _run_turntable(engine, scene, args)
        print(f"wrote {len(paths)} frames: {paths[0]} .. {paths[-1]}")
        return 0

    if args.animate and args.scan:
        err = _check_sequence_pattern(args.dump_image)
        if err:
            print(f"error: {err}", file=sys.stderr)
            return 2
        with profile_ctx:
            paths = _run_animation_scan(engine, scene, args)
        print(f"wrote {len(paths)} frames: {paths[0]} .. {paths[-1]}")
        return 0

    with profile_ctx:
        if args.scan:
            from .runtime.offline import (make_noise_scan_renderer,
                                          make_scan_renderer)
            import jax
            import jax.numpy as jnp
            import numpy as np

            transport = "mis" if args.mis else (
                "unbiased" if args.unbiased else None
            )
            start = engine.frame_count  # continues a --load-state resume
            rng = np.random.RandomState(args.deterministic)
            seeds = (
                rng.randint(0, 2**32, size=args.frames, dtype=np.uint64)
                + np.arange(start, start + args.frames, dtype=np.uint64)
            ).astype(np.uint32)
            if args.until_noise is not None:
                # Convergence stop composed with the scan: a while_loop
                # over chunk-of-frames scans, all on device.
                render = make_noise_scan_renderer(
                    scene, args.frames, args.until_noise,
                    full_color=args.full_color, backend=args.backend,
                    accel=args.accel, transport=transport,
                    denoise=args.denoise,
                    denoise_passes=args.denoise_passes,
                    tonemap=args.tonemap, exposure=args.exposure,
                )
                engine.state, rgb, glyphs, rays, frames_done = render(
                    engine.state, engine.camera.pose(), jnp.asarray(seeds),
                    np.int32(start),
                )
                engine.frame_count = start + int(
                    jax.device_get(frames_done)
                )
            else:
                render = make_scan_renderer(
                    scene, args.frames, full_color=args.full_color,
                    backend=args.backend, accel=args.accel,
                    transport=transport, denoise=args.denoise,
                    denoise_passes=args.denoise_passes,
                    tonemap=args.tonemap, exposure=args.exposure,
                )
                engine.state, rgb, glyphs, rays = render(
                    engine.state, engine.camera.pose(), jnp.asarray(seeds),
                    np.int32(start),
                )
                engine.frame_count = start + args.frames
            rgb, glyphs, rays = jax.device_get((rgb, glyphs, rays))
            mean_spp = float("nan")
        else:
            rgb, glyphs, rays, mean_spp, _heatmap = engine.run_headless(
                args.frames, until_noise=args.until_noise
            )
    if args.dump_image:
        import numpy as np

        from .utils import imageio

        rgb = np.asarray(rgb)
        if args.dump_image.endswith(".png"):
            imageio.write_png(args.dump_image, rgb)
        else:
            imageio.write_ppm(args.dump_image, rgb)
        print(f"wrote {args.dump_image}")
    if args.save_state:
        from .utils.statefile import save_state

        save_state(args.save_state, engine.state, engine.frame_count, engine.camera)
        print(f"saved state to {args.save_state}")
    if not args.full_color and glyphs is not None and args.dump_image is None:
        from .ops.tonemap import GLYPH_RAMP
        import numpy as np

        for row in np.asarray(glyphs):
            print("".join(GLYPH_RAMP[min(int(i), 67)] for i in row))
    if args.verbose:
        # frame_count reflects early convergence stops (--until-noise);
        # --animate pins it at 0 (its accumulation never advances) and
        # counts rendered frames on the animation clock instead.
        n_done = engine._anim_t if args.animate else engine.frame_count
        print(f"[headless] {n_done} frames, {float(rays):.3e} "
              f"rays in last frame, mean spp {float(mean_spp):.1f}",
              file=sys.stderr)
    return 0


def _turntable_path(pattern: str, k: int) -> str:
    """`%d`-style pattern, or insert _NNN before the extension."""
    if "%" in pattern:
        return pattern % k
    import os

    stem, ext = os.path.splitext(pattern)
    return f"{stem}_{k:03d}{ext or '.png'}"


def _check_sequence_pattern(pattern: str) -> "str | None":
    """Validate a --dump-image sequence pattern BEFORE rendering: a stray
    or incomplete '%' (e.g. '100%.png') would otherwise raise only after
    the full render completes. ('%s' formats an int fine, so it passes —
    outputs stay unique per frame.) Returns an error string or None."""
    try:
        _turntable_path(pattern, 0)
    except (TypeError, ValueError) as e:
        return (f"--dump-image pattern {pattern!r} is not a valid %d "
                f"sequence pattern ({e})")
    return None


def _orbit_poses(camera, scene, n):
    """n cameras orbiting the scene centroid in the XZ plane, keeping the
    starting camera's height and orbit radius."""
    import numpy as np

    from .models.camera import Camera

    center = scene.centroid()
    rel = np.asarray(camera.position, np.float32) - center
    radius = float(np.hypot(rel[0], rel[2]))
    if radius < 1e-6:
        radius = max(1.0, float(np.linalg.norm(rel)))
    phi0 = float(np.arctan2(rel[2], rel[0]))
    height = float(rel[1])
    out = []
    for k in range(n):
        phi = phi0 + 2.0 * np.pi * k / n
        pos = center + np.array(
            [radius * np.cos(phi), height, radius * np.sin(phi)], np.float32
        )
        out.append(Camera.look_at(pos, center))
    return out


def _write_frame_image(path, rgb):
    import numpy as np

    from .utils import imageio

    rgb = np.asarray(rgb)
    if path.endswith(".ppm"):
        imageio.write_ppm(path, rgb)
    else:
        imageio.write_png(path, rgb)


def _run_animation_scan(engine, scene, args):
    """--animate --scan: the whole animation as one XLA program — the
    per-frame geometry arrays (host-evaluated animator) become scanned
    inputs to the dynamic-scene step (runtime/offline.py)."""
    import jax
    import numpy as np

    from .models.animate import ANIMATOR_KEYS, ANIMATORS
    from .ops.dynamic import pack_scene
    from .runtime.offline import make_animation_scan_renderer

    animator = ANIMATORS[args.animate]
    arrays0 = pack_scene(scene)
    frames = [animator(arrays0, t) for t in range(args.frames)]
    arrays_seq = {
        k: np.stack([f[k] for f in frames]) for k in arrays0
    }
    rng = np.random.RandomState(args.deterministic)
    seeds = rng.randint(0, 2**32, size=args.frames,
                        dtype=np.uint64).astype(np.uint32)
    render = make_animation_scan_renderer(
        scene, args.frames, full_color=args.full_color,
        backend=args.backend,
        transport="mis" if args.mis else (
            "unbiased" if args.unbiased else None
        ),
        animated=ANIMATOR_KEYS.get(args.animate),
        denoise=args.denoise, denoise_passes=args.denoise_passes,
        tonemap=args.tonemap, exposure=args.exposure,
    )
    # Output paths resolved BEFORE the render (like _run_turntable), so a
    # bad pattern fails before compute, not after.
    paths = [_turntable_path(args.dump_image, k)
             for k in range(args.frames)]
    rgbs, _glyphs, _rays = jax.device_get(
        render(engine.camera.pose(), arrays_seq, seeds)
    )
    for path, rgb in zip(paths, rgbs):
        _write_frame_image(path, rgb)
    return paths


def _run_turntable(engine, scene, args):
    """Render `args.turntable` poses orbiting the scene centroid, each pose
    accumulating `args.frames` frames. Default: one compiled step driven
    per frame (the pose is a runtime input — no retraces across the
    orbit). With --scan, the ENTIRE orbit compiles into one XLA program
    (lax.scan over poses, fori over accumulation frames — zero per-frame
    and per-pose dispatch, runtime/offline.py)."""
    import numpy as np

    from .runtime.state import init_state

    cams = _orbit_poses(engine.camera, scene, args.turntable)
    paths = [_turntable_path(args.dump_image, k)
             for k in range(args.turntable)]

    if args.scan:
        import jax

        from .runtime.offline import make_orbit_scan_renderer

        render = make_orbit_scan_renderer(
            scene, args.turntable, args.frames,
            full_color=args.full_color, backend=args.backend,
            accel=args.accel,
            transport="mis" if args.mis else (
                "unbiased" if args.unbiased else None
            ),
            denoise=args.denoise, denoise_passes=args.denoise_passes,
            tonemap=args.tonemap, exposure=args.exposure,
        )
        rng = np.random.RandomState(args.deterministic)
        seeds = rng.randint(
            0, 2**32, size=(args.turntable, args.frames), dtype=np.uint64
        ).astype(np.uint32)
        poses = np.stack([c.pose() for c in cams])
        rgbs, _glyphs, _rays = jax.device_get(render(poses, seeds))
        for path, rgb in zip(paths, rgbs):
            _write_frame_image(path, rgb)
        return paths

    for k, cam in enumerate(cams):
        engine.camera = cam
        engine.state = init_state(scene)
        engine.frame_count = 0
        rgb, _g, _r, _s, _hm = engine.run_headless(
            args.frames, until_noise=args.until_noise
        )
        _write_frame_image(paths[k], rgb)
        if args.verbose:
            print(f"[turntable] pose {k + 1}/{args.turntable} -> {paths[k]}",
                  file=sys.stderr)
    return paths


if __name__ == "__main__":
    sys.exit(main())
