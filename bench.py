#!/usr/bin/env python
"""Benchmark harness for one GPU. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mray/s", "ms_per_frame": N,
   "device": {...}, ...}

Headline metric: Mray/s at the north-star config -- Cornell_Box.json at
400x200, 16 spp, max_depth 32. A ray = one scene-traversal sweep
(primary/bounce closest-hit or NEE shadow any-hit), counted on device per
lane (only for lanes whose reference thread would traverse -- masked and
ballast work is *not* counted).

Protocol: N chained frames x 3 reps, report the MEDIAN rep. N is
per-config (CONFIGS[...]["frames"]); each timed rep ends in one host sync.
The chained (sub-ms) configs size their timed reps by wall time (>=
MIN_REP_S per rep, calibrated by one untimed rep). Rays are summed over the
timed frames themselves (adaptive scenes draw different budgets per frame).

Correctness gate: unless --no-check, the card renders the north-star
config with backend=pallas and backend=jnp on the same seeds, and a small
config (128x64, 16 spp, depth 8) on the card and on the host CPU; the
verdicts (runtime/compare.py tolerances) ride in the JSON line as "check".

The harness needs a GPU: without one it exits non-zero and prints no
result.

Usage: python bench.py [--config NAME] [--backend auto|pallas|jnp]
                       [--frames N] [--reps N] [--shard SPEC] [--trace DIR]
                       [--verbose] [--all] [--no-check] [--check-only]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

# Minimum wall time per timed rep for the chained (sub-ms) configs, so the
# one rep-ending host sync stays noise.
MIN_REP_S = 1.0
# Frames under the profiler with --trace (a short steady window).
TRACE_FRAMES = 8

CONFIGS = {
    # "frames" = timed frames per rep: long enough that the one
    # rep-ending host sync is a small share of the rep. --frames overrides.
    "north_star": dict(scene="Cornell_Box", spp=16, depth=32, frames=480),
    # Small configs are dispatch-bound under per-frame driving. chain=8
    # measures them through the chained headless path (8 frames per
    # dispatch, offline.make_chunk_renderer) -- what `--frames` runs.
    "cornell_80x40": dict(  # config 1: tiny ASCII
        scene="Cornell_Box", width=80, height=40, spp=1, depth=4, chain=8,
        frames=960,
    ),
    "cornell_shipped": dict(scene="Cornell_Box",
                            frames=480),  # 400x200, 128 spp, depth 3
    "demo": dict(scene="demo", chain=8,
                 frames=960),  # adaptive many-sphere scene
    "scene2": dict(scene="scene2", chain=8, frames=960),
    # config 3: 100-frame temporal accumulation compiled as one lax.scan
    "scan100": dict(scene="Cornell_Box", spp=16, depth=32, scan=100),
    # many-primitive scenes: accel='auto' picks the array-resident
    # fori_loop sweep (ops/arrayscene.py) above ~96 primitives — fixed
    # code size, like the reference's storage-buffer loop
    "stress256": dict(scene="stress:256", frames=480),
    "stress1024": dict(scene="stress:1024", frames=192),
    # many-TRIANGLE mesh scene (models/mesh.py icosphere, 1280 faces +
    # light + floor): the triangle sweep at mesh scale, same array path
    "mesh1280": dict(scene="icosphere:3", frames=192),
    # dielectric extension at north-star params: the Cornell variant with
    # two glass spheres (Fresnel refract-or-reflect branch, one extra
    # gated draw) — measures the glass branch's cost against north_star
    "glass": dict(scene="cornell_glass", spp=16, depth=32, frames=480),
    # volumetric-fog extension at north-star params (fog = extinction
    # density; analytic distance sampling, +1 gated draw per bounce and
    # NEE transmittance exp) — measures the medium's cost vs north_star
    "fog": dict(scene="Cornell_Box", spp=16, depth=32, fog=0.15,
                frames=480),
    # image-texture extension at north-star params: the packaged textured
    # scene (two 64x64 atlas textures = 64 rows; per-lane texel gathers in
    # every scheduler iteration + the polynomial-atan2 spherical uv) —
    # measures the gather's cost against north_star
    "textured": dict(scene="textured", spp=16, depth=32, frames=480),
    # environment-map sky at north-star params: the packaged envmap scene
    # (globe texture sampled by ray direction on every miss; sky-lit only,
    # no NEE lights) — measures the miss-branch sky fetch
    "envmap": dict(scene="envmap", spp=16, depth=32, frames=480),
    # normal-map extension at north-star params: the packaged bumpy scene
    # (bricks color + derived normal map on floor/wall = TWO mapped
    # fetches + the tangent-frame math every iteration)
    "bumpy": dict(scene="bumpy", spp=16, depth=32, frames=480),
    # à-trous denoiser at north-star params (ops/denoise.py; 3 passes =
    # 75 shifted-plane taps fused into the step epilogue) — measures the
    # reconstruction filter's cost against north_star
    "denoised": dict(scene="Cornell_Box", spp=16, depth=32, denoise=1.0,
                     frames=480),
    # stratified pixel-jitter sampler at north-star params (ops/tracer.py
    # stratify_jitter: base samples on a jittered 2x2 sub-pixel grid —
    # two bit-ops + two selects per base ray gen) — the sampler should be
    # measured ~free against north_star
    "stratified": dict(scene="Cornell_Box", spp=16, depth=32,
                       sampler="stratified", frames=480),
    # many-LIGHT scene (lights:16 — 16 emissive spheres over a diffuse
    # field): the reference's NEE loop casts one shadow ray per light per
    # bounce, so per-bounce occlusion cost is O(L) primitive sweeps;
    # `light_sample: power` (the one-light NEE extension,
    # ops/tracer._one_light_nee) picks ONE light by emitted power and
    # casts a single weighted shadow ray — O(1). The A/B pair measures
    # that scaling win at L=16 (note Mray/s counts OWED rays, which the
    # one-light mode also cuts ~8.5x per bounce — compare ms/frame).
    "manylights": dict(scene="lights:16", frames=192),
    "manylights_one": dict(scene="lights:16", light_sample="power",
                           frames=480),
    # dynamic (animated) scenes: geometry values are runtime inputs
    # (ops/dynamic.py; --animate); north-star params, orbit animator
    "dynamic": dict(scene="Cornell_Box", spp=16, depth=32, dynamic=True,
                    frames=480),
    # animated AT SCALE: dynamic x array traversal (ops/arrayscene.py
    # ArrayDynPrims) — runtime values AND O(1) kernel code in N
    "dynamic1024": dict(scene="stress:1024", dynamic=True, frames=192),
}


def _load(cfg):
    from terminal_raytracer.models import Camera, load_scene

    scene = load_scene(cfg["scene"]).with_overrides(
        width=cfg.get("width"),
        height=cfg.get("height"),
        samples_per_pixel=cfg.get("spp"),
        max_depth=cfg.get("depth"),
        sampler=cfg.get("sampler"),
        light_sample=cfg.get("light_sample"),
    )
    if cfg.get("fog"):
        from terminal_raytracer.models.scene import Fog

        scene = scene.with_overrides(fog=Fog(density=float(cfg["fog"])))
    return scene, Camera()


def _frames_for(config_name: str, override) -> int:
    """Timed frames per rep: explicit --frames, else the config's protocol
    count (CONFIGS[...]["frames"]), else 48."""
    if override is not None:
        return int(override)
    return int(CONFIGS[config_name].get("frames", 48))


def run_bench(config_name: str, backend: str, frames, reps: int,
              verbose: bool, shard=None, trace=None):
    """Returns (median Mray/s, median fps, mean occupancy or None, compile
    seconds) over `reps` timed repetitions. `frames=None` uses the
    config's protocol frame count. Compile seconds = the first (untimed)
    call, compile included. `shard`: a --shard spec; the step runs on that
    device mesh (parallel/mesh.py). `trace`: a directory for a profiler
    trace of TRACE_FRAMES more frames, summarised on stderr."""
    import jax

    from terminal_raytracer.runtime import init_state, make_render_step

    cfg = CONFIGS[config_name]
    frames = _frames_for(config_name, frames)
    scene, cam = _load(cfg)
    pose = cam.pose()

    if (shard or trace) and any(cfg.get(k) for k in ("scan", "chain",
                                                      "dynamic")):
        raise SystemExit(f"error: --shard and --trace take a per-frame "
                         f"static config, not {config_name!r}")
    if cfg.get("scan"):
        return _run_bench_scan(scene, pose, cfg["scan"], backend, reps,
                               verbose, config_name)
    if cfg.get("chain"):
        return _run_bench_chain(scene, pose, int(cfg["chain"]), backend,
                                frames, reps, verbose, config_name)

    dynamic = bool(cfg.get("dynamic"))
    if shard:
        from terminal_raytracer.parallel import (make_mesh,
                                                 make_sharded_render_step)
        from terminal_raytracer.runtime.engine import _parse_shard

        step, init_sharded = make_sharded_render_step(
            scene, make_mesh(*_parse_shard(shard)), full_color=True,
            backend=backend, denoise=float(cfg.get("denoise", 0.0)))
        backend = step.backend
        state = init_sharded()
    else:
        # The shipped --animate path: runtime values, with the animator's
        # static key subset folded back to baked constants
        # (runtime/engine.py does the same).
        from terminal_raytracer.models.animate import ANIMATOR_KEYS

        step = make_render_step(
            scene, full_color=True, backend=backend, dynamic=dynamic,
            animated=ANIMATOR_KEYS["orbit"] if dynamic else None,
            denoise=float(cfg.get("denoise", 0.0)))
        state = init_state(scene)
    if dynamic:
        from terminal_raytracer.models.animate import orbit
        from terminal_raytracer.ops.dynamic import pack_scene

        arrays0 = pack_scene(scene)
        raw_step = step
        anim_t = [0]

        def step(state, pose, seed, frame):
            arrays = orbit(arrays0, anim_t[0])
            anim_t[0] += 1
            # animated frames render fresh (no temporal accumulation)
            return raw_step(state, pose, seed, np.int32(0), arrays)

    # Warm-up / compile.
    t_c = time.perf_counter()
    out = step(state, pose, np.uint32(1), np.int32(0))
    jax.device_get(out.rays)
    compile_s = time.perf_counter() - t_c
    state = out.state

    mrays, fpss = [], []
    frame = 1
    for _ in range(reps):
        # Submit `frames` chained steps (state donation keeps accumulation
        # on-device, like the interactive loop); keep each frame's on-device
        # ray count and sync once at the end. Rays are summed over exactly
        # the timed frames (adaptive budgets differ per frame/seed).
        ray_counts, occ_counts = [], []
        t0 = time.perf_counter()
        for _ in range(frames):
            out = step(state, pose, np.uint32(1 + frame), np.int32(frame))
            state = out.state
            ray_counts.append(out.rays)
            occ_counts.append(out.occupancy)
            frame += 1
        total_rays = float(sum(jax.device_get(ray_counts)))
        dt = (time.perf_counter() - t0) / frames
        mrays.append(total_rays / frames / dt / 1e6)
        fpss.append(1.0 / dt)

    # Measured lane occupancy over the final rep's frames (-1 -> omit).
    occ_vals = [float(o) for o in jax.device_get(occ_counts)]
    occ = (sum(occ_vals) / len(occ_vals)
           if occ_vals and min(occ_vals) >= 0.0 else None)

    if trace:
        with jax.profiler.trace(trace):
            for _ in range(TRACE_FRAMES):
                out = step(state, pose, np.uint32(1 + frame),
                           np.int32(frame))
                state = out.state
                frame += 1
            jax.block_until_ready(out)
        print(trace_summary(trace), file=sys.stderr)

    mray_s = statistics.median(mrays)
    fps = statistics.median(fpss)
    if verbose:
        px = scene.width * scene.height
        rpf = total_rays / frames
        occ_txt = f" | occ {occ * 100.0:.1f}%" if occ is not None else ""
        print(
            f"[bench] {config_name} backend={backend}"
            f"{f' shard={shard}' if shard else ''} "
            f"{scene.width}x{scene.height} spp={scene.samples_per_pixel} "
            f"depth={scene.max_depth} | protocol {frames}f x {reps} reps | "
            f"median {1e3 / fps:.2f} ms/frame = {fps:.1f} fps | "
            f"{rpf:.3e} rays/frame -> {mray_s:.1f} Mray/s "
            f"(reps: {', '.join(f'{m:.0f}' for m in mrays)}) | "
            f"{rpf / px:.1f} rays/px{occ_txt} | compile {compile_s:.1f} s",
            file=sys.stderr,
        )
    return mray_s, fps, occ, compile_s


def _run_bench_chain(scene, pose, chain, backend, frames, reps, verbose,
                     config_name):
    """Overhead-bound configs: the chained headless path — `chain` frames
    folded into one dispatch (runtime/offline.make_chunk_renderer, what
    Engine.run_headless runs). Protocol is unchanged (`frames` timed frames
    per rep), just fewer dispatches."""
    import jax

    from terminal_raytracer.runtime import init_state
    from terminal_raytracer.runtime.offline import make_chunk_renderer

    render = make_chunk_renderer(scene, chain, full_color=True,
                                 backend=backend)
    n_chunks = max(frames // chain, 1)

    def seeds_for(frame):
        return (np.uint32(1) + np.arange(frame, frame + chain,
                                         dtype=np.uint64)).astype(np.uint32)

    state = init_state(scene)
    t_c = time.perf_counter()
    out, _rays = render(state, pose, seeds_for(0), np.int32(0))
    jax.device_get(out.rays)  # compile
    compile_s = time.perf_counter() - t_c
    state = out.state

    # Wall-time-sized reps: calibrate with one untimed rep at the config's
    # protocol count and scale the timed reps to >= MIN_REP_S of wall time
    # (ceil'd to whole chunks, capped at 16x to bound the bench budget).
    frame = chain
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        out, rays_k = render(state, pose, seeds_for(frame), np.int32(frame))
        state = out.state
        frame += chain
    jax.device_get(out.rays)
    calib_dt = time.perf_counter() - t0
    scale = min(max(1, int(np.ceil(MIN_REP_S / max(calib_dt, 1e-3)))), 16)
    n_chunks *= scale

    mrays, fpss = [], []
    for _ in range(reps):
        ray_vecs = []
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            out, rays_k = render(state, pose, seeds_for(frame),
                                 np.int32(frame))
            state = out.state
            ray_vecs.append(rays_k)
            frame += chain
        total_rays = float(sum(float(np.sum(r))
                               for r in jax.device_get(ray_vecs)))
        dt = (time.perf_counter() - t0) / (n_chunks * chain)
        mrays.append(total_rays / (n_chunks * chain) / dt / 1e6)
        fpss.append(1.0 / dt)

    mray_s = statistics.median(mrays)
    fps = statistics.median(fpss)
    if verbose:
        px = scene.width * scene.height
        rpf = total_rays / (n_chunks * chain)
        print(
            f"[bench] {config_name} backend={backend} "
            f"{scene.width}x{scene.height} spp={scene.samples_per_pixel} "
            f"depth={scene.max_depth} | chained x{chain}: "
            f"{n_chunks * chain}f x {reps} reps | "
            f"median {1e3 / fps:.2f} ms/frame = {fps:.1f} fps | "
            f"{rpf:.3e} rays/frame -> {mray_s:.1f} Mray/s "
            f"(reps: {', '.join(f'{m:.0f}' for m in mrays)}) | "
            f"{rpf / px:.1f} rays/px | compile {compile_s:.1f} s",
            file=sys.stderr,
        )
    return mray_s, fps, None, compile_s


def _run_bench_scan(scene, pose, n_frames, backend, reps, verbose,
                    config_name):
    """The whole accumulation compiled as one lax.scan."""
    import jax

    from terminal_raytracer.runtime import init_state
    from terminal_raytracer.runtime.offline import make_scan_renderer

    render = make_scan_renderer(scene, n_frames, full_color=True,
                                backend=backend)
    rng = np.random.RandomState(0)

    def seeds():
        return (
            rng.randint(0, 2**32, size=n_frames, dtype=np.uint64)
            + np.arange(n_frames, dtype=np.uint64)
        ).astype(np.uint32)

    # Warm-up / compile.
    t_c = time.perf_counter()
    state, rgb, glyphs, rays = render(init_state(scene), pose, seeds())
    jax.device_get(rays)
    compile_s = time.perf_counter() - t_c

    mrays, fpss = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, rgb, glyphs, rays = render(init_state(scene), pose, seeds())
        total_rays = float(jax.device_get(rays))
        dt = time.perf_counter() - t0
        mrays.append(total_rays / dt / 1e6)
        fpss.append(n_frames / dt)

    mray_s = statistics.median(mrays)
    fps = statistics.median(fpss)
    if verbose:
        print(
            f"[bench] {config_name} backend={backend} "
            f"{scene.width}x{scene.height} spp={scene.samples_per_pixel} "
            f"depth={scene.max_depth} | {n_frames}-frame scan x {reps} reps | "
            f"median {fps:.1f} fps | {mray_s:.1f} Mray/s "
            f"(reps: {', '.join(f'{m:.0f}' for m in mrays)}) | "
            f"compile {compile_s:.1f} s",
            file=sys.stderr,
        )
    return mray_s, fps, None, compile_s


def busy_ns(intervals) -> int:
    """Length of the union of (start, duration) intervals, in ns."""
    busy, end = 0, None
    for start, dur in sorted(intervals):
        stop = start + dur
        if end is None or start > end:
            busy += dur
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def trace_summary(trace_dir: str, top: int = 6) -> str:
    """Per-device reduction of the newest profiler trace under `trace_dir`:
    the window (first to last device event), the busy share (the union of
    the device's stream events over the window), and the kernels with the
    most device time (event count and summed duration)."""
    import glob
    import os

    from jax.profiler import ProfileData

    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    out = [f"[trace] {path}"]
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        spans, kernels = [], {}
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                spans.append((ev.start_ns, ev.duration_ns))
                n, ns = kernels.get(ev.name, (0, 0))
                kernels[ev.name] = (n + 1, ns + ev.duration_ns)
        if not spans:
            continue
        t0 = min(s for s, _d in spans)
        window = max(s + d for s, d in spans) - t0
        out.append(f"[trace] {plane.name}: window {window / 1e6:.3f} ms, "
                   f"busy {busy_ns(spans) / window:.3f}")
        for name, (n, ns) in sorted(kernels.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
            out.append(f"[trace]   {ns / 1e6:9.3f} ms  {n:4d}x  {name[:80]}")
    return "\n".join(out)


def run_check(verbose: bool) -> str:
    """On-card agreement gate (runtime/compare.py): the kernel vs the jnp
    path at north-star size, and the card vs the host CPU at 128x64, 16
    spp, depth 8. Returns a 'pass(...)' / 'FAIL(...)' string."""
    import jax

    from terminal_raytracer.models import load_scene
    from terminal_raytracer.runtime import compare as cmp

    base = load_scene("Cornell_Box")
    ns = base.with_overrides(samples_per_pixel=16, max_depth=32)
    small = base.with_overrides(width=128, height=64, samples_per_pixel=16,
                                max_depth=8)
    cpu = jax.devices("cpu")[0]
    ref_small = cmp.render_once(small, "jnp", device=cpu)
    results = {
        "kernel_vs_jnp": cmp.compare(cmp.render_once(ns, "pallas"),
                                     cmp.render_once(ns, "jnp"),
                                     cmp.KERNEL_VS_JNP),
        "jnp_gpu_vs_cpu": cmp.compare(cmp.render_once(small, "jnp"),
                                      ref_small, cmp.CARD_VS_CPU),
        "kernel_gpu_vs_cpu": cmp.compare(cmp.render_once(small, "pallas"),
                                         ref_small, cmp.CARD_VS_CPU),
    }
    ok = all(r["ok"] for r in results.values())
    verdict = ("pass" if ok else "FAIL") + "(" + "; ".join(
        f"{k}: budgets differ on {r['budget_mismatch_share']:.2e} of px, "
        f"rays_rel={r['rays_rel']:.2e}, mean_rel={r['mean_rel']:.2e}, "
        f"max_abs={r['max_abs']:.2e}" for k, r in results.items()) + ")"
    if verbose or not ok:
        print(f"[check] {verdict}", file=sys.stderr)
    return verdict


def device_record() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="north_star", choices=sorted(CONFIGS))
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "pallas", "jnp"])
    ap.add_argument("--frames", type=int, default=None,
                    help="timed frames per rep (default: the config's "
                         "protocol count)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shard", metavar="SPEC", default=None,
                    help="time the multi-card step on a device mesh "
                         "(N, px:N, sp:N or px:N,sp:M, as the CLI's "
                         "--shard); per-frame configs only")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="after the timed reps, write a profiler trace of "
                         f"{TRACE_FRAMES} frames to DIR and print its "
                         "per-device summary")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every config (verbose table)")
    ap.add_argument("--no-check", action="store_true",
                    help="skip the on-card agreement gate")
    ap.add_argument("--check-only", action="store_true",
                    help="run only the correctness gate, then exit")
    args = ap.parse_args()

    import jax

    from terminal_raytracer.utils.cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"error: bench.py measures a GPU; JAX found "
              f"{jax.devices()[0].platform!r}", file=sys.stderr)
        return 2
    enable_compile_cache()

    if args.check_only:
        verdict = run_check(verbose=True)
        print(json.dumps({"metric": "agreement check", "check": verdict,
                          "device": device_record()}))
        return 0 if verdict.startswith("pass") else 1

    if args.all:
        for name in CONFIGS:
            if name == args.config:
                continue
            run_bench(name, args.backend, args.frames, args.reps,
                      verbose=True)

    mray_s, fps, occ, compile_s = run_bench(args.config, args.backend,
                                            args.frames, args.reps,
                                            args.verbose, args.shard,
                                            args.trace)

    from terminal_raytracer.runtime.engine import _parse_shard
    from terminal_raytracer.runtime.state import resolve_backend

    backend = resolve_backend(args.backend)
    if args.shard and _parse_shard(args.shard)[1] > 1:
        backend = "jnp"  # the sample split runs on the XLA path
    record = {
        "metric": f"Mray/s @ {args.config}",
        "value": mray_s,
        "unit": "Mray/s",
        "ms_per_frame": 1e3 / fps,
        "fps": fps,
        "compile_s": compile_s,
        "backend": backend,
        "shard": args.shard,
        "protocol": f"median of {args.reps} reps x "
                    f"{_frames_for(args.config, args.frames)} frames"
                    + (" (wall-time-sized to >= 1 s reps)"
                       if CONFIGS[args.config].get("chain") else ""),
        "device": device_record(),
    }
    if occ is not None:
        # Measured sweep-weighted lane occupancy (owed sweeps / executed
        # lane-iteration sweeps), final rep mean.
        record["occupancy"] = occ
    if not args.no_check:
        record["check"] = run_check(args.verbose)
    print(json.dumps(record))
    return 0 if record.get("check", "pass").startswith("pass") else 1


if __name__ == "__main__":
    sys.exit(main())
