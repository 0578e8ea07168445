"""Build a Scene in code — no JSON needed — and print the ASCII render.

Shows the three primitive kinds plus an OBJ-style mesh (models/mesh.py):
Scene is a frozen pytree of Python floats, hashable, and jit-static; the
renderer bakes it into the compiled kernel.

Usage: python examples/custom_scene.py
"""

import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


import jax
import numpy as np

from terminal_raytracer.models import Camera, mesh, scene as sm
from terminal_raytracer.ops.tonemap import GLYPH_RAMP
from terminal_raytracer.runtime import init_state, make_render_step


def mat(color, emission=(0.0, 0.0, 0.0), reflectivity=0.0):
    return sm.Material(color=color, emission=emission,
                       reflectivity=reflectivity)


# A little stage: floor plane, one mirror sphere, a light, and an
# icosahedron mesh transformed into place.
verts, faces = mesh.icosahedron()
scene = sm.Scene(
    width=80, height=30, samples_per_pixel=4, max_depth=4,
    frames_to_accumulate=100,
    camera=sm.Camera_Config(fov_degrees=55.0, char_aspect_ratio=0.55),
    spheres=(
        sm.Sphere(center=(2.0, 5.0, -5.0), radius=1.0,
                  material=mat((1.0, 1.0, 1.0), emission=(12.0, 12.0, 12.0))),
        sm.Sphere(center=(-1.8, 0.8, -6.0), radius=0.8,
                  material=mat((0.9, 0.9, 0.95), reflectivity=0.9)),
    ),
    planes=(
        sm.Plane(point=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0),
                 material=mat((0.5, 0.55, 0.6))),
    ),
    triangles=mesh.mesh_triangles(
        verts, faces, mat((0.85, 0.6, 0.2), reflectivity=0.1),
        scale=1.3, translate=(0.6, 1.5, -5.5), rotate_y_degrees=30.0,
    ),
)

step = make_render_step(scene, full_color=False)
state, cam = init_state(scene), Camera()
for f in range(8):
    out = step(state, cam.pose(), np.uint32(11 + f), np.int32(f))
    state = out.state
for row in jax.device_get(out.glyphs):
    print("".join(GLYPH_RAMP[i] for i in row))
