#!/usr/bin/env python
"""Smoke test of the path tracer on one NVIDIA GPU.

Runs the main path the way users run it and checks what comes out:

1. the device: JAX must find a GPU (else exit 1, no result line);
2. headless renders through `python -m terminal_raytracer` at the sizes
   users run -- the shipped Cornell box (400x200, 128 spp, depth 3), the
   north-star settings (16 spp, depth 32), `stress:1024` (array-resident
   traversal), `--animate orbit` and a 100-frame `--scan` -- each with
   backend auto (the megakernel) and backend jnp at the same seeds; the
   two images must agree (IMAGE_LIMITS), and bench.py times each cell;
3. the interactive viewer through a pty: a few frames, one WASD key
   (accumulation resets), ESC, exit 0;
4. agreement on the card (runtime/compare.py tolerances): `bench.py
   --check-only` (kernel vs jnp at north-star size, card vs host CPU at
   128x64) and the `gpu`-marked tests.

Every phase is a child process run one after another, and this process
never touches the GPU itself, so exactly one process holds the card at a
time. Any failing phase stops the run with a non-zero exit.

`--four-cards` runs only the sharded path on four cards, in this process:
the `px:4` and `px:2,sp:2` meshes at 400x200 (with the `--denoise` halo
exchange) against the single-card result.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

GPU = "gpu"  # the platform name JAX reports for an NVIDIA card
HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke")  # images; listed in .gitignore
ENV = dict(os.environ, PYTHONPATH=os.pathsep.join(
    p for p in (HERE, os.environ.get("PYTHONPATH")) if p))

# Kernel and jnp images of one render, same seeds: decisions flip only on
# isolated pixels (runtime/compare.py). A pixel is "off" when a channel
# differs by more than IMAGE_TOL["levels"] of 255.
IMAGE_TOL = dict(levels=2)
# Per cell: (share of pixels off, image-mean difference in levels). Each
# limit is about 10x the cell's reading on an H100 (PERF.md), never above
# 1% of pixels. A lost 128-pixel kernel block breaks the share limit of
# cornell_shipped and the mean limit of every other cell.
IMAGE_LIMITS = {
    "cornell_shipped": (1e-4, 0.01),  # read 0 px off, mean diff < 0.001
    "north_star": (9e-3, 0.05),  # read 9.0e-4, 0.004
    "stress1024": (1e-2, 0.05),  # read 2.9e-3, 0.004
    "animate_orbit": (6e-4, 0.03),  # read 6.25e-5, 0.002
    "scan100": (1e-2, 0.02),  # read 2.28e-3, 0.001
}

# Headless cells: (name, CLI arguments, bench.py config or None).
CELLS = [
    ("cornell_shipped", ["--scene", "Cornell_Box", "--frames", "16"],
     "cornell_shipped"),
    ("north_star", ["--scene", "Cornell_Box", "--spp", "16", "--depth", "32",
                    "--frames", "16"], "north_star"),
    ("stress1024", ["--scene", "stress:1024", "--frames", "4"],
     "stress1024"),
    ("animate_orbit", ["--scene", "Cornell_Box", "--spp", "16", "--depth",
                       "32", "--animate", "orbit", "--frames", "8"],
     "dynamic"),
    ("scan100", ["--scene", "Cornell_Box", "--spp", "16", "--depth", "32",
                 "--scan", "--frames", "100"], "scan100"),
]
# The sharded cell: the north-star settings at the shipped 400x200.
FOUR_CARD_SCENE = dict(samples_per_pixel=16, max_depth=32)
BENCH_FRAMES = {"cornell_shipped": 96, "north_star": 192, "stress1024": 24,
                "dynamic": 96, "scan100": None}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def run(label: str, args, timeout: float = 600) -> subprocess.CompletedProcess:
    """One phase as a child process; a non-zero exit fails the run."""
    t0 = time.perf_counter()
    r = subprocess.run(args, cwd=HERE, env=ENV, capture_output=True,
                       text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        fail(f"{label}: exit {r.returncode}")
    print(f"[{label}] ok in {dt:.1f} s", flush=True)
    return r


def device_info() -> dict:
    code = ("import jax, json; d = jax.devices(); print(json.dumps("
            "{'platform': d[0].platform, 'kind': d[0].device_kind, "
            "'count': len(d)}))")
    r = run("device", [sys.executable, "-c", code], timeout=300)
    dev = json.loads(r.stdout.strip().splitlines()[-1])
    if dev["platform"] != GPU:
        fail(f"JAX found no GPU (platform {dev['platform']!r})")
    return dev


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail("nvidia-smi failed: " + r.stderr.strip())
    return r.stdout.strip()


def read_image(path: str):
    """An 8-bit binary PPM as an (h, w, 3) uint8 array."""
    import re

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    m = re.match(rb"P6\s+(\d+)\s+(\d+)\s+255\s", data)
    if not m:
        fail(f"{path}: not an 8-bit PPM")
    w, h = int(m.group(1)), int(m.group(2))
    return np.frombuffer(data[m.end():m.end() + w * h * 3],
                         np.uint8).reshape(h, w, 3)


def compare_images(name: str, kernel_path: str, jnp_path: str) -> None:
    import numpy as np

    a = read_image(kernel_path).astype(np.int32)
    b = read_image(jnp_path).astype(np.int32)
    if a.shape != b.shape:
        fail(f"{name}: image shapes {a.shape} vs {b.shape}")
    off = np.max(np.abs(a - b), axis=-1) > IMAGE_TOL["levels"]
    share = float(np.mean(off))
    dmean = abs(float(a.mean()) - float(b.mean()))
    max_share, max_dmean = IMAGE_LIMITS[name]
    print(f"[{name}] kernel vs jnp image: {share:.3e} of px off by "
          f"> {IMAGE_TOL['levels']} levels (limit {max_share:g}), mean "
          f"{a.mean():.4f} vs {b.mean():.4f}, diff {dmean:.4f} (limit "
          f"{max_dmean:g})", flush=True)
    if a.max() == 0:
        fail(f"{name}: black image")
    if share > max_share or dmean > max_dmean:
        fail(f"{name}: kernel and jnp images disagree")


def headless_cells() -> None:
    os.makedirs(WORK, exist_ok=True)
    cli = [sys.executable, "-m", "terminal_raytracer", "--full-color",
           "--deterministic", "7", "--verbose"]
    for name, args, _cfg in CELLS:
        paths = {}
        for backend in ("auto", "jnp"):
            path = os.path.join(WORK, f"{name}_{backend}.ppm")
            r = run(f"{name}/{backend}", cli + args + [
                "--backend", backend, "--dump-image", path], timeout=600)
            for line in r.stderr.splitlines():
                if line.startswith("device:"):
                    print(f"[{name}/{backend}] {line}", flush=True)
            paths[backend] = path
        compare_images(name, paths["auto"], paths["jnp"])


def bench_cells() -> None:
    for name, _args, cfg in CELLS:
        cmd = [sys.executable, "bench.py", "--config", cfg, "--reps", "3",
               "--no-check", "--verbose"]
        if BENCH_FRAMES.get(cfg):
            cmd += ["--frames", str(BENCH_FRAMES[cfg])]
        r = run(f"bench/{cfg}", cmd, timeout=600)
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"[bench/{cfg}] backend={rec['backend']} "
              f"{rec['ms_per_frame']:.3f} ms/frame, {rec['value']:.1f} "
              f"Mray/s, compile {rec['compile_s']:.1f} s"
              + (f", occupancy {rec['occupancy']:.3f}"
                 if "occupancy" in rec else ""), flush=True)


def interactive() -> None:
    """The TUI through a pty: frames render, 'w' moves the camera and
    resets accumulation, ESC exits 0 (pattern: tests/test_cli.py)."""
    import fcntl
    import pty
    import re
    import select
    import struct
    import termios

    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ,
                struct.pack("HHHH", 50, 160, 0, 0))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "terminal_raytracer", "--scene",
         "Cornell_Box", "--full-color", "--deterministic", "3"],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, cwd=HERE,
        env=ENV)
    os.close(slave)
    buf = b""

    def read_until(pred, timeout):
        nonlocal buf
        deadline = time.time() + timeout
        while time.time() < deadline:
            r, _, _ = select.select([master], [], [], 0.2)
            if r:
                try:
                    buf += os.read(master, 1 << 16)
                except OSError:
                    break
            if pred():
                return True
        return False

    def frames():
        return [int(m) for m in re.findall(rb"Frame: (\d+)/", buf)]

    try:
        if not read_until(lambda: len(frames()) >= 1 and max(frames()) >= 5,
                          300):
            fail("interactive: no frames: " + buf[-800:].decode(
                "utf-8", "replace"))
        status = re.findall(rb"Frame: [^\r\n\x1b]*", buf)[-1].decode()
        print(f"[interactive] status line: {status}", flush=True)
        if f"{GPU}/" not in status:
            fail("interactive: status line does not name gpu/pallas")
        n_before = len(frames())
        os.write(master, b"w")
        if not read_until(lambda: any(f <= 2 for f in
                                      frames()[n_before:]), 120):
            fail("interactive: accumulation did not reset after 'w'")
        os.write(master, b"\x1b")
        if not read_until(lambda: b"Exiting." in buf, 120):
            fail("interactive: ESC did not exit")
        rc = proc.wait(timeout=120)
        if rc != 0:
            fail(f"interactive: exit {rc}: " + proc.stderr.read().decode())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        os.close(master)
    print(f"[interactive] ok in {time.perf_counter() - t0:.1f} s",
          flush=True)


def agreement() -> None:
    r = run("check", [sys.executable, "bench.py", "--check-only"],
            timeout=900)
    print(f"[check] {json.loads(r.stdout.strip().splitlines()[-1])['check']}",
          flush=True)
    r = run("gpu-tests", [sys.executable, "-m", "pytest", "tests/", "-m",
                          "gpu", "-q", "-s", "-p", "no:cacheprovider",
                          "--durations=5"], timeout=900)
    for line in r.stdout.strip().splitlines():
        if "budgets differ" in line or "passed" in line:
            print(f"[gpu-tests] {line}", flush=True)


def blitter() -> None:
    code = ("from terminal_raytracer.runtime.blit import _load_native; "
            "print('native' if _load_native() is not None else 'python')")
    r = run("blitter", [sys.executable, "-c", code], timeout=300)
    print(f"[blitter] {r.stdout.strip()}", flush=True)


def four_cards() -> dict:
    """The sharded path on four cards, in this process: px:4 against the
    single-card render (ray counts exactly equal, images equal), with the
    denoiser's ppermute halos; px:2,sp:2 (decorrelated sample shards)
    against it by image mean."""
    import jax
    import numpy as np

    from terminal_raytracer.models import Camera, load_scene
    from terminal_raytracer.parallel import make_mesh, make_sharded_render_step
    from terminal_raytracer.runtime import init_state, make_render_step

    devs = jax.devices()
    if devs[0].platform != GPU or len(devs) < 4:
        fail(f"--four-cards needs four GPUs, JAX found {devs}")
    scene = load_scene("Cornell_Box").with_overrides(**FOUR_CARD_SCENE)
    pose = Camera().pose()

    def frames(step, state, n=4):
        for f in range(n):
            out = step(state, pose, np.uint32(11 + f), np.int32(f))
            state = out.state
        return jax.block_until_ready(out)

    # Correctness only: bench.py --shard times these meshes.
    runs = {}
    with jax.default_device(devs[0]):
        for denoise in (0.0, 1.0):
            step = make_render_step(scene, denoise=denoise)
            runs[("single", denoise)] = frames(step, init_state(scene))
    for spec, n_px, n_sp in (("px:4", 4, 1), ("px:2,sp:2", 2, 2)):
        for denoise in ((0.0, 1.0) if n_sp == 1 else (0.0,)):
            step, mk = make_sharded_render_step(
                scene, make_mesh(n_px, n_sp), denoise=denoise)
            out = frames(step, mk())
            shards = {s.device for s in out.state.acc.addressable_shards}
            if len(shards) != n_px * n_sp:
                fail(f"{spec}: state lives on {len(shards)} devices")
            runs[(spec, denoise)] = out
            print(f"[four-cards] {spec} denoise={denoise} "
                  f"backend={step.backend}: state on {len(shards)} devices",
                  flush=True)
    for denoise in (0.0, 1.0):
        ref = runs[("single", denoise)]
        px = runs[("px:4", denoise)]
        if float(px.rays) != float(ref.rays):
            fail(f"px:4 rays {float(px.rays)} != single {float(ref.rays)}")
        diff = np.abs(np.asarray(px.rgb, np.int32)
                      - np.asarray(ref.rgb, np.int32))
        print(f"[four-cards] px:4 vs single denoise={denoise}: rays equal, "
              f"max rgb diff {int(diff.max())}", flush=True)
        if diff.max() > IMAGE_TOL["levels"]:
            fail("px:4 image differs from the single-card image")
    ref = runs[("single", 0.0)]
    sp = runs[("px:2,sp:2", 0.0)]
    m_ref = float(np.mean(np.asarray(ref.state.acc)))
    m_sp = float(np.mean(np.asarray(sp.state.acc)))
    rel = abs(m_sp - m_ref) / m_ref
    # Sample shards draw decorrelated RNG chains, so only the estimate
    # agrees: the 400x200 image mean of 4 accumulated frames carries well
    # under 1% noise; 3% bounds it with margin.
    print(f"[four-cards] px:2,sp:2 vs single: image mean {m_sp:.5f} vs "
          f"{m_ref:.5f} (rel {rel:.2e}, limit 3e-2)", flush=True)
    if rel > 0.03:
        fail("px:2,sp:2 image mean differs from the single-card mean")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def main(argv) -> int:
    if argv not in ([], ["--four-cards"]):
        print(__doc__, file=sys.stderr)
        return 2
    if argv == ["--four-cards"]:
        print(card_line(), flush=True)
        dev = four_cards()
    else:
        dev = device_info()
        print(card_line(), flush=True)
        blitter()
        headless_cells()
        interactive()
        bench_cells()
        agreement()
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
