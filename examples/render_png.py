"""Minimal library render: accumulate N frames headless, write a PNG.

Usage: python examples/render_png.py [out.png] [scene] [frames]
"""

import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.runtime import init_state, make_render_step
from terminal_raytracer.utils import imageio

out_path = sys.argv[1] if len(sys.argv) > 1 else "out.png"
scene_name = sys.argv[2] if len(sys.argv) > 2 else "scene2"
n_frames = int(sys.argv[3]) if len(sys.argv) > 3 else 16

scene = load_scene(scene_name)
if jax.default_backend() != "gpu":
    # Off the GPU: shrink the workload so the example stays snappy.
    scene = scene.with_overrides(width=120, height=60, samples_per_pixel=8,
                                 max_depth=4)

step = make_render_step(scene, full_color=True)  # kernel on a GPU, else jnp
state, cam = init_state(scene), Camera()
for f in range(n_frames):
    out = step(state, cam.pose(), np.uint32(1 + f), np.int32(f))
    state = out.state  # donated on-device accumulation
print(f"{n_frames} frames, {float(out.rays):.3e} rays in the last one")
imageio.write_png(out_path, np.asarray(out.rgb))
print(f"wrote {out_path}")
