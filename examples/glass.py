"""Dielectric (glass) materials: transparency + ior on any primitive.

A glass sphere over a checker-less floor in front of an emissive wall —
refraction bends the wall's light through the sphere (flip `transparency`
to 0 to see the same sphere go matte). The glass branch is a scene
property: scenes without dielectrics compile to the exact reference-parity
program (PARITY.md).

Usage: python examples/glass.py [out.png]
"""

import sys
from pathlib import Path

# Runnable from anywhere: the examples live one level below the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np

from terminal_raytracer.models import Camera, scene as sm
from terminal_raytracer.runtime import init_state, make_render_step
from terminal_raytracer.utils import imageio


def mat(color, emission=(0.0, 0.0, 0.0), reflectivity=0.0,
        transparency=0.0, ior=1.5):
    return sm.Material(color=color, emission=emission,
                       reflectivity=reflectivity,
                       transparency=transparency, ior=ior)


scene = sm.Scene(
    width=160, height=80, samples_per_pixel=8, max_depth=8,
    frames_to_accumulate=1000,
    camera=sm.Camera_Config(fov_degrees=50.0, char_aspect_ratio=1.0),
    spheres=(
        # The star: a clear glass ball (95% refractive branch, crown-ish
        # index). Try ior=1.33 (water) or 2.4 (diamond).
        sm.Sphere(center=(0.0, -0.2, -2.2), radius=0.6,
                  material=mat((1.0, 1.0, 1.0), transparency=0.95)),
        # A matte companion for contrast.
        sm.Sphere(center=(-1.2, -0.6, -3.0), radius=0.4,
                  material=mat((0.8, 0.3, 0.3))),
        # Key light.
        sm.Sphere(center=(2.0, 2.5, -1.5), radius=0.5,
                  material=mat((1.0, 1.0, 1.0), emission=(18.0, 18.0, 18.0))),
    ),
    planes=(
        sm.Plane(point=(0.0, -1.0, 0.0), normal=(0.0, 1.0, 0.0),
                 material=mat((0.6, 0.6, 0.65))),
        # Emissive back wall: watch it refract through the glass ball.
        sm.Plane(point=(0.0, 0.0, -6.0), normal=(0.0, 0.0, 1.0),
                 material=mat((0.0, 0.0, 0.0), emission=(1.5, 2.0, 2.5))),
    ),
    triangles=(),
)

step = make_render_step(scene, full_color=True)
state, cam = init_state(scene), Camera()
frames = 32
for f in range(frames):
    out = step(state, cam.pose(), np.uint32(7000 + f), np.int32(f))
    state = out.state
rgb = np.asarray(jax.device_get(out.rgb))

path = sys.argv[1] if len(sys.argv) > 1 else "glass.png"
imageio.write_png(path, rgb)
print(f"wrote {path} ({frames} accumulated frames, "
      f"{scene.width}x{scene.height})")
