"""Dynamic (animated) geometry: scene values stream through ONE compiled
step as runtime arrays — geometry moves every frame, zero recompiles.

Usage: python examples/animate.py [out_dir] [n_frames]
"""

import os
import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models.animate import ANIMATOR_KEYS, ANIMATORS
from terminal_raytracer.ops.dynamic import pack_scene
from terminal_raytracer.runtime import init_state, make_render_step
from terminal_raytracer.utils import imageio

out_dir = sys.argv[1] if len(sys.argv) > 1 else "anim_frames"
n_frames = int(sys.argv[2]) if len(sys.argv) > 2 else 8

scene = load_scene("demo")
if jax.default_backend() != "gpu":
    scene = scene.with_overrides(width=100, height=50, samples_per_pixel=4,
                                 max_depth=4)

# animated=ANIMATOR_KEYS["orbit"]: only the keys the orbit animator varies
# stream at runtime; everything else folds back to baked constants.
step = make_render_step(scene, full_color=True, dynamic=True,
                        animated=ANIMATOR_KEYS["orbit"])
arrays0 = pack_scene(scene)
orbit = ANIMATORS["orbit"]

os.makedirs(out_dir, exist_ok=True)
state, cam = init_state(scene), Camera()
for t in range(n_frames):
    # frame_number pinned to 0: animated frames render fresh (temporal
    # accumulation would smear moving geometry).
    out = step(state, cam.pose(), np.uint32(1 + t), np.int32(0),
               orbit(arrays0, t))
    state = out.state
    path = os.path.join(out_dir, f"frame_{t:03d}.png")
    imageio.write_png(path, np.asarray(out.rgb))
print(f"wrote {n_frames} frames to {out_dir}/")
