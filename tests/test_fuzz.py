"""Randomized-scene parity fuzz: seeded random geometry/materials, checked
three ways — wavefront tracer vs the independent scalar reference tracer
(same-seed sample means), jnp oracle vs the GPU kernel, and
NaN/finiteness. Catches interaction bugs hand-written scenes miss
(overlapping primitives, lights inside geometry, mirror chains, grazing
planes)."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from scalar_ref import render_pixel  # noqa: E402

from terminal_raytracer.models import Camera  # noqa: E402
from terminal_raytracer.models.scene import scene_from_dict  # noqa: E402
from terminal_raytracer.ops import pallas_kernel  # noqa: E402
from terminal_raytracer.ops import tracer as tracer_mod  # noqa: E402

POSE = Camera().pose()


def random_scene(rng: np.random.RandomState, n_spheres=4, n_planes=2,
                 n_triangles=2, spp=4, depth=4, extensions=False):
    """`extensions=True` additionally randomizes the schema-superset
    material channels (transparency/ior dielectrics, metal roughness) —
    used by the extension fuzz below, never by the scalar-parity fuzz
    (tests/scalar_ref.py models reference semantics only)."""

    def v3(lo, hi):
        return rng.uniform(lo, hi, 3).round(3).tolist()

    def material(force_light=False):
        is_light = force_light or rng.rand() < 0.3
        refl = float(rng.choice([0.0, 1.0, round(float(rng.rand()), 3)]))
        mat = {
            "color": v3(0.0, 1.0),
            "emission": (np.round(rng.uniform(0.5, 5.0, 3), 3).tolist()
                         if is_light else [0.0, 0.0, 0.0]),
            "reflectivity": 0.0 if is_light else refl,
        }
        if extensions and not is_light:
            roll = rng.rand()
            if roll < 0.4:  # dielectric (branch probabilities sum <= 1)
                mat["reflectivity"] = round(refl * 0.25, 3)
                mat["transparency"] = round(
                    float(rng.uniform(0.3, 1.0 - mat["reflectivity"])), 3
                )
                mat["ior"] = round(float(rng.uniform(1.05, 2.4)), 3)
            elif roll < 0.7 and refl > 0.0:  # brushed metal
                mat["roughness"] = round(float(rng.uniform(0.05, 1.0)), 3)
        return mat

    spheres = []
    for i in range(n_spheres):
        spheres.append({
            "center": [round(float(rng.uniform(-3, 3)), 3),
                       round(float(rng.uniform(-2, 2)), 3),
                       round(float(rng.uniform(-8, -2)), 3)],
            "radius": round(float(rng.uniform(0.3, 1.2)), 3),
            # i == 0 forces at least one light per scene
            "__mat": material(force_light=(i == 0)),
        })
    planes = [{
        "point": [0.0, round(float(rng.uniform(-3, -1)), 3), 0.0],
        "normal": [0.0, 1.0, 0.0], "__mat": material(),
    }]
    for _ in range(n_planes - 1):
        n = rng.uniform(-1, 1, 3)
        n = n / max(np.linalg.norm(n), 1e-3)
        planes.append({
            "point": v3(-6, 0), "normal": np.round(n, 3).tolist(),
            "__mat": material(),
        })
    triangles = []
    for _ in range(n_triangles):
        base = np.array([rng.uniform(-3, 3), rng.uniform(-2, 2),
                         rng.uniform(-8, -2)])
        triangles.append({
            "v0": np.round(base, 3).tolist(),
            "v1": np.round(base + rng.uniform(-1.5, 1.5, 3), 3).tolist(),
            "v2": np.round(base + rng.uniform(-1.5, 1.5, 3), 3).tolist(),
            "__mat": material(),
        })

    def fold(p):
        m = p.pop("__mat")
        p.update(m)
        return p

    return scene_from_dict({
        "width": 64, "height": 32, "samples_per_pixel": spp,
        "max_depth": depth, "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "spheres": [fold(p) for p in spheres],
        "planes": [fold(p) for p in planes],
        "triangles": [fold(p) for p in triangles],
    })


def _vec_pixels(scene, pixels, seed, frame):
    tracer = tracer_mod.PathTracer(scene)
    xs = np.array([p[0] for p in pixels], np.int32)
    ys = np.array([p[1] for p in pixels], np.int32)
    cam = tracer_mod.cam_from_pose(POSE)
    cur, _var, _tot, _rays = jax.jit(
        lambda s, f: tracer.render_lanes(cam, xs, ys, s, f)
    )(np.uint32(seed), np.int32(frame))
    return np.stack(
        [np.asarray(cur.x), np.asarray(cur.y), np.asarray(cur.z)], -1
    )


PIXELS = [(7, 5), (32, 16), (56, 28)]


@pytest.mark.parametrize("case", range(5))
def test_fuzz_scalar_parity(case):
    rng = np.random.RandomState(1000 + case)
    scene = random_scene(rng)
    seed = int(rng.randint(1, 2**31))
    vec = _vec_pixels(scene, PIXELS, seed=seed, frame=case)
    assert np.isfinite(vec).all(), f"case {case}: non-finite radiance"
    for i, (px, py) in enumerate(PIXELS):
        ref = render_pixel(scene, px, py, seed=seed, frame_number=case,
                           n_samples=4)
        np.testing.assert_allclose(
            vec[i], ref, rtol=5e-4, atol=5e-6,
            err_msg=f"case {case} pixel ({px},{py})",
        )


@pytest.mark.parametrize("case", range(2))
def test_fuzz_pallas_matches_oracle(case):
    rng = np.random.RandomState(2000 + case)
    scene = random_scene(rng, spp=8)  # base 4 < spp: adaptive phase live
    of = jax.jit(tracer_mod.PathTracer(scene).render_frame)
    cur_o, _vo, tot_o, rays_o = of(POSE, np.uint32(42), np.int32(0))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42), np.int32(0))
    assert float(rays_p) == float(rays_o), f"case {case}"
    np.testing.assert_array_equal(
        np.asarray(tot_p), np.asarray(tot_o), f"case {case}"
    )
    # Decisions are exact (asserted above); radiance differs only by
    # summation order between the kernel's regen accumulation and the
    # oracle's lockstep accumulation — fuzz scenes are brighter than the shipped ones, so a
    # relative tolerance.
    np.testing.assert_allclose(
        np.asarray(cur_p.x), np.asarray(cur_o.x), rtol=2e-3, atol=2e-5,
        err_msg=f"case {case}",
    )


@pytest.mark.parametrize("case", range(2))
def test_fuzz_extension_materials_pallas_matches_oracle(case):
    """Random glass/rough scenes: the extension branches (gated Fresnel +
    fuzz draws, below-surface absorption, TIR) must keep the oracle and
    the Pallas pipeline in exact decision agreement — the same invariant
    the reference-semantics fuzz pins, now over the superset schema."""
    rng = np.random.RandomState(3000 + case)
    scene = random_scene(rng, spp=8, extensions=True)
    assert scene.has_dielectrics or scene.has_rough_metals, (
        f"case {case}: fuzz produced no extension materials; "
        f"reseed the case"
    )
    of = jax.jit(tracer_mod.PathTracer(scene).render_frame)
    cur_o, _vo, tot_o, rays_o = of(POSE, np.uint32(42), np.int32(0))
    img_o = np.asarray(cur_o.x)
    assert np.isfinite(img_o).all(), f"case {case}: oracle non-finite"
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42), np.int32(0))
    assert float(rays_p) == float(rays_o), f"case {case}"
    np.testing.assert_array_equal(
        np.asarray(tot_p), np.asarray(tot_o), f"case {case}"
    )
    np.testing.assert_allclose(
        np.asarray(cur_p.x), img_o, rtol=2e-3, atol=2e-5,
        err_msg=f"case {case}",
    )
