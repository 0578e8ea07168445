"""CLI surface tests: headless rendering, image/state IO, flag errors, and
the interactive TUI driven end-to-end through a pty (raw mode, key handling,
ANSI frames, status line, clean exit + terminal restore)."""

import os
import pty
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

# Append to PYTHONPATH, never replace: a site may register plugins on it.
ENV = dict(
    os.environ,
    PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}",
)

CPU_PRELUDE = (
    "import jax; jax.config.update('jax_platforms','cpu');"
    "from terminal_raytracer.cli import main; import sys;"
)


def run_cli(args, timeout=180):
    code = CPU_PRELUDE + f"sys.exit(main({args!r}))"
    return subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True,
        timeout=timeout,
        cwd=REPO,
        env=ENV,
    )


TINY = ["--width", "48", "--height", "16", "--spp", "4", "--depth", "2",
        "--backend", "jnp", "--scene", "scene2", "--deterministic", "3"]


def test_headless_ascii_dump(tmp_path):
    out = run_cli(TINY + ["--frames", "2"])
    assert out.returncode == 0, out.stderr.decode()
    text = out.stdout.decode()
    assert "outputting with ASCII characters" in text
    assert "$" in text  # the light renders as bright glyphs


def test_image_and_state_roundtrip(tmp_path):
    ppm = tmp_path / "f.ppm"
    png = tmp_path / "f.png"
    st = tmp_path / "s.npz"
    out = run_cli(TINY + ["--frames", "2", "--dump-image", str(ppm),
                          "--save-state", str(st)])
    assert out.returncode == 0, out.stderr.decode()
    from terminal_raytracer.utils.imageio import read_ppm

    img = read_ppm(ppm)
    assert img.shape == (16, 48, 3) and img.max() > 0

    out = run_cli(TINY + ["--frames", "1", "--load-state", str(st),
                          "--dump-image", str(png)])
    assert out.returncode == 0, out.stderr.decode()
    data = png.read_bytes()
    assert data.startswith(b"\x89PNG") and b"IEND" in data


def test_flag_errors():
    out = run_cli(["--path", "/nope.json", "--frames", "1"])
    assert out.returncode == 2
    assert "error" in out.stderr.decode()
    out = run_cli(["--path", "/a.json", "--scene", "demo", "--frames", "1"])
    assert out.returncode == 2
    assert "mutually exclusive" in out.stderr.decode()
    # config validation: nonsense render params are rejected with clear
    # messages (scene.__post_init__), not rendered as garbage
    out = run_cli(TINY + ["--frames", "1", "--spp", "0"])
    assert out.returncode == 2
    assert "samples_per_pixel" in out.stderr.decode()
    out = run_cli(TINY + ["--frames", "1", "--width", "1"])
    assert out.returncode == 2
    assert "width" in out.stderr.decode()
    # --frames 0 is a clean usage error, not an AttributeError crash
    out = run_cli(TINY + ["--frames", "0"])
    assert out.returncode == 2
    assert "--frames" in out.stderr.decode()


def test_interactive_pty():
    """Drive the TUI through a pty: frames render, keys steer, ESC exits,
    terminal state is restored."""
    code = CPU_PRELUDE + (
        "sys.exit(main(['--scene','scene2','--width','40','--height','12',"
        "'--spp','2','--depth','2','--backend','jnp','--deterministic','1']))"
    )
    master, slave = pty.openpty()
    # Give the pty a real window size (raw openpty reports 0x0).
    import fcntl
    import struct
    import termios

    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 100, 0, 0))
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE,
        cwd=REPO, env=ENV,
    )
    os.close(slave)
    buf = b""

    def read_until(substr: bytes, timeout: float):
        nonlocal buf
        deadline = time.time() + timeout
        while time.time() < deadline:
            r, _, _ = select.select([master], [], [], 0.2)
            if r:
                try:
                    buf += os.read(master, 65536)
                except OSError:
                    break
            if substr in buf:
                return True
        return False

    try:
        # First frame: status line appears.
        assert read_until(b"Frame:", 150), buf[-2000:].decode("utf-8", "replace")
        # ANSI truecolor cells present
        assert b"\x1b[38;2;" in buf
        # Steer: w + arrow-up; accumulation resets to Frame: 1
        os.write(master, b"w")
        time.sleep(0.5)
        os.write(master, b"\x1b[A")
        # variance debug view toggle
        os.write(master, b"v")
        time.sleep(0.5)
        # ESC exits
        os.write(master, b"\x1b")
        assert read_until(b"Exiting.", 60), buf[-2000:].decode("utf-8", "replace")
        # Terminal restored: cursor shown again
        assert b"\x1b[?25h" in buf
        proc.wait(timeout=30)
        assert proc.returncode == 0, proc.stderr.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)


def test_turntable_sequence(tmp_path):
    """--turntable renders an orbit of poses and writes a numbered PNG
    sequence; poses differ (the images do too) and the step is reused
    across poses (pose is a runtime input)."""
    out_pattern = str(tmp_path / "turn.ppm")
    out = run_cli(TINY + ["--frames", "1", "--turntable", "3",
                          "--dump-image", out_pattern])
    assert out.returncode == 0, out.stderr.decode()
    paths = [tmp_path / f"turn_{k:03d}.ppm" for k in range(3)]
    assert all(p.exists() for p in paths), list(tmp_path.iterdir())
    from terminal_raytracer.utils import imageio

    imgs = [imageio.read_ppm(p) for p in paths]
    assert imgs[0].shape == (16, 48, 3)
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])


def test_turntable_flag_errors():
    # missing --frames, then missing --dump-image, then bad count
    out = run_cli(TINY + ["--turntable", "3"])
    assert out.returncode == 2 and b"--frames" in out.stderr
    out = run_cli(TINY + ["--frames", "1", "--turntable", "3"])
    assert out.returncode == 2 and b"--dump-image" in out.stderr
    out = run_cli(TINY + ["--frames", "1", "--turntable", "0",
                          "--dump-image", "x.png"])
    assert out.returncode == 2


def test_look_at_faces_target():
    from terminal_raytracer.models.camera import Camera

    cam = Camera.look_at([3.0, 1.0, -2.0], [0.0, 0.0, -6.0])
    fwd, _r, _u = cam.basis()
    want = np.array([-3.0, -1.0, -4.0])
    want = want / np.linalg.norm(want)
    np.testing.assert_allclose(fwd, want, atol=1e-6)


def test_load_state_shape_mismatch_clear_error(tmp_path):
    st = tmp_path / "s.npz"
    out = run_cli(TINY + ["--frames", "1", "--save-state", str(st)])
    assert out.returncode == 0, out.stderr.decode()
    # resume with a different resolution -> clear error, exit 2
    out = run_cli(["--width", "32", "--height", "8", "--spp", "4",
                   "--depth", "2", "--backend", "jnp", "--scene", "scene2",
                   "--frames", "1", "--load-state", str(st)])
    assert out.returncode == 2
    assert b"48x16" in out.stderr and b"32x8" in out.stderr


def test_compile_cache_populates(tmp_path):
    """With $JAX_COMPILATION_CACHE_DIR set, that directory fills and the
    program sets no other (nothing lands under HOME either)."""
    home = tmp_path / "home"
    home.mkdir()
    env = dict(ENV, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "xla"),
               HOME=str(home))
    code = CPU_PRELUDE + f"sys.exit(main({(TINY + ['--frames', '1'])!r}))"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=180, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr.decode()
    cache = tmp_path / "xla"
    assert cache.is_dir()
    # the whole-image render compile exceeds the 1 s persistence threshold
    assert any(cache.iterdir()), "no cache entries written"
    assert not any(home.iterdir())


def test_compile_cache_default_is_checkout_path():
    """Unset, the cache lands at the fixed checkout path; set, JAX's own
    setting is honoured and not overridden."""
    code = ("import jax; from terminal_raytracer.utils.cache import "
            "enable_compile_cache as e; r = e(); "
            "print(r, jax.config.jax_compilation_cache_dir)")
    env = {k: v for k, v in ENV.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=120, cwd=REPO, env=env, text=True)
    want = str(REPO / ".jax_cache")
    assert r.stdout.split() == [want, want], r.stderr
    env["JAX_COMPILATION_CACHE_DIR"] = "/nonexistent/elsewhere"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=120, cwd=REPO, env=env, text=True)
    assert r.stdout.split() == ["None", "/nonexistent/elsewhere"], r.stderr


def test_no_compile_cache_writes_nothing(tmp_path):
    env = dict(ENV, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "xla"))
    args = TINY + ["--frames", "1", "--no-compile-cache"]
    code = CPU_PRELUDE + f"sys.exit(main({args!r}))"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=180, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr.decode()
    cache = tmp_path / "xla"
    assert not cache.exists() or not any(cache.iterdir())


def test_interactive_animate_pty():
    """--animate in the interactive viewer: frames keep rendering (the
    animation clock advances; accumulation never stops it), keys still
    steer, ESC exits cleanly."""
    code = CPU_PRELUDE + (
        "sys.exit(main(['--scene','scene2','--width','40','--height','12',"
        "'--spp','2','--depth','2','--backend','jnp','--deterministic','1',"
        "'--animate','bob']))"
    )
    master, slave = pty.openpty()
    import fcntl
    import struct
    import termios

    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 100, 0, 0))
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE,
        cwd=REPO, env=ENV,
    )
    os.close(slave)
    buf = b""

    def read_until(substr: bytes, timeout: float):
        nonlocal buf
        deadline = time.time() + timeout
        while time.time() < deadline:
            r, _, _ = select.select([master], [], [], 0.2)
            if r:
                try:
                    buf += os.read(master, 65536)
                except OSError:
                    break
            if substr in buf:
                return True
        return False

    try:
        assert read_until(b"Frame:", 150), buf[-1500:].decode("utf-8", "replace")
        n0 = buf.count(b"Frame:")
        # animated frames keep coming without any input
        deadline = time.time() + 60
        while time.time() < deadline and buf.count(b"Frame:") < n0 + 3:
            read_until(b"\xff\xff", 1.0)
        assert buf.count(b"Frame:") >= n0 + 3, "animation stalled"
        os.write(master, b"w")
        time.sleep(0.3)
        os.write(master, b"\x1b")
        assert read_until(b"Exiting.", 60), buf[-1500:].decode("utf-8", "replace")
        proc.wait(timeout=30)
        assert proc.returncode == 0, proc.stderr.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)


def test_turntable_scan_one_program(tmp_path):
    """--turntable --scan: the whole orbit compiles into one XLA program
    and writes the same numbered sequence."""
    out_pattern = str(tmp_path / "orbit.ppm")
    out = run_cli(TINY + ["--frames", "2", "--turntable", "3", "--scan",
                          "--dump-image", out_pattern])
    assert out.returncode == 0, out.stderr.decode()
    from terminal_raytracer.utils import imageio

    imgs = [imageio.read_ppm(tmp_path / f"orbit_{k:03d}.ppm")
            for k in range(3)]
    assert imgs[0].shape == (16, 48, 3)
    assert not np.array_equal(imgs[0], imgs[1])
    assert not np.array_equal(imgs[1], imgs[2])


def test_animate_scan_sequence(tmp_path):
    """--animate --scan: the whole animation as one XLA program, written
    as a numbered sequence."""
    out_pattern = str(tmp_path / "anim.ppm")
    out = run_cli(TINY + ["--frames", "3", "--animate", "bob", "--scan",
                          "--dump-image", out_pattern])
    assert out.returncode == 0, out.stderr.decode()
    from terminal_raytracer.utils import imageio

    imgs = [imageio.read_ppm(tmp_path / f"anim_{k:03d}.ppm")
            for k in range(3)]
    assert imgs[0].shape == (16, 48, 3)
    assert not np.array_equal(imgs[0], imgs[2])
    # missing --dump-image -> clear error
    out = run_cli(TINY + ["--frames", "3", "--animate", "bob", "--scan"])
    assert out.returncode == 2 and b"--dump-image" in out.stderr


def test_until_noise_scan_composition():
    """--until-noise composes with --scan: a huge threshold
    stops after the first on-device chunk; the incompatible combinations
    are rejected up front."""
    out = run_cli(TINY + ["--frames", "8", "--scan", "--until-noise", "1e9"])
    assert out.returncode == 0, out.stderr.decode()

    out = run_cli(TINY + ["--frames", "2", "--animate", "orbit",
                          "--until-noise", "0.5"])
    assert out.returncode == 2
    assert "--until-noise" in out.stderr.decode()

    out = run_cli(TINY + ["--frames", "2", "--turntable", "2", "--scan",
                          "--until-noise", "0.5", "--dump-image", "x.png"])
    assert out.returncode == 2
    assert "--turntable" in out.stderr.decode()
