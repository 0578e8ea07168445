"""Multi-card rendering: shard the image over every available device.

On a multi-GPU host this scales pixel rows across the cards; to try it
on CPU:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip.py

(The same thing is available from the CLI as --shard N | px:N,sp:M.)
"""

import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


import jax
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.parallel import make_mesh, make_sharded_render_step

n_dev = len(jax.devices())
scene = load_scene("scene2")
if jax.default_backend() != "gpu":
    scene = scene.with_overrides(width=128, height=64, samples_per_pixel=8,
                                 max_depth=4)
# Pixel-row sharding needs height % n_px == 0: use the largest device
# count that divides this scene's height (e.g. scene2's 100 rows on an
# 8-card host -> px:4).
n_px = max(d for d in range(1, n_dev + 1) if scene.height % d == 0)

mesh = make_mesh(n_px=n_px, n_sp=1)  # pure pixel-row data parallelism
step, init_state = make_sharded_render_step(scene, mesh)
print(f"{n_dev} devices, mesh {dict(mesh.shape)}; "
      f"{scene.height // n_px} rows per device")

state, cam = init_state(), Camera()
for f in range(8):
    out = step(state, cam.pose(), np.uint32(1 + f), np.int32(f))
    state = out.state
print(f"rendered {scene.width}x{scene.height}, "
      f"{float(out.rays):.3e} rays in the last frame; "
      f"rgb gathered to host: {np.asarray(out.rgb).shape}")
