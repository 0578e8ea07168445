"""Procedural checker textures — capability extension tests.

`checker_color` + `checker_scale` recolor hits on a world-space 3-D
checkerboard (ops/tracer.py bounce_step) — pure lane math, no table
reads. Same contract as the other extension channels
(test_dielectric / test_roughness): statically gated — scenes without
checkers compile to the exact pre-extension program — and agreeing across
every traversal and scheduler.
"""

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import scene as sm
from terminal_raytracer.ops import dynamic as dyn_mod
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops.tracer import PathTracer

POSE = Camera().pose()

_SCENES = Path(sm.__file__).parent / "scenes"


def _checker_cornell(**overrides):
    """Cornell Box with a checkered floor."""
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["planes"][0].update(checker_color=[0.1, 0.1, 0.1],
                            checker_scale=2.0)
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


def _render(tracer, seed=42, frame=0):
    return jax.jit(tracer.render_frame)(POSE, np.uint32(seed),
                                        np.int32(frame))


def test_schema_and_static_gate():
    m = sm.Material(color=(1, 1, 1), emission=(0, 0, 0), reflectivity=0.0)
    assert m.checker_color is None and not m.is_checker
    s = _checker_cornell()
    assert s.planes[0].material.is_checker and s.has_checker
    plain = load_scene("Cornell_Box")
    assert not plain.has_checker
    assert not any(k.endswith(("_ckr", "_cks"))
                   for k, _ in dyn_mod.scene_keys(plain))
    assert {"p_ckr", "p_ckg", "p_ckb", "p_cks"} <= {
        k for k, _ in dyn_mod.scene_keys(s)
    }
    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg["planes"][0].update(checker_color=[0.1, 0.1, 0.1],
                            checker_scale=0.0)
    with pytest.raises(ValueError, match="checker_scale"):
        sm.scene_from_dict(cfg)


def test_checker_alternates_cells():
    # Emissive sky over a red/blue checkered floor: the floor region of
    # the first-bounce image must contain BOTH colors in alternating
    # world cells.
    cfg = {
        "width": 64, "height": 16, "samples_per_pixel": 4, "max_depth": 2,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [1, 0, 0], "emission": [0, 0, 0],
                    "reflectivity": 0.0, "checker_color": [0, 0, 1],
                    "checker_scale": 1.0}],
        "spheres": [{"center": [0, 5, -3], "radius": 1.0,
                     "color": [0, 0, 0], "emission": [10, 10, 10],
                     "reflectivity": 0.0}],
    }
    scene = sm.scene_from_dict(cfg)
    cur, *_ = _render(PathTracer(scene))
    r, b = np.asarray(cur.x), np.asarray(cur.z)
    floor = slice(10, 16)  # bottom rows look down at the plane
    red_px = int((r[floor] > 2 * b[floor]).sum())
    blue_px = int((b[floor] > 2 * r[floor]).sum())
    assert red_px > 20 and blue_px > 20, (red_px, blue_px)


def test_traversals_agree_on_checker_scene():
    scene = _checker_cornell(width=64, height=16, samples_per_pixel=4,
                             max_depth=4)
    cur, _var, tot, rays = _render(PathTracer(scene))
    for accel in ("array", "grid"):
        c2, _v2, t2, r2 = _render(PathTracer(scene, accel=accel))
        for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z)):
            # Radiance: allow the documented XLA-CPU FMA ulp on the
            # array sweep (ops/arrayscene.py _fori); grid is the same
            # unrolled code as baked and stays bitwise.
            if accel == "array":
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=accel)
            else:
                np.testing.assert_array_equal(np.asarray(a),
                                              np.asarray(b), err_msg=accel)
        np.testing.assert_array_equal(np.asarray(t2), np.asarray(tot),
                                      err_msg=accel)
        assert float(r2) == float(rays), accel
    t_dyn = PathTracer(scene, dynamic=True)
    c3, _v3, t3, r3 = jax.jit(
        lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a)
    )(POSE, np.uint32(42), np.int32(0), dyn_mod.pack_scene(scene))
    for a, b in ((c3.x, cur.x), (c3.y, cur.y), (c3.z, cur.z)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(t3), np.asarray(tot))
    assert float(r3) == float(rays)


def test_animator_folding_composes_with_extension_channels():
    # DynPrims with an animator key set folds every non-animated key back
    # to baked constants — including the extension channels (glass/rough/
    # checker values come from _static, not the runtime operands). At the
    # animator's identity pose the render must equal the fully-baked
    # tracer bit-for-bit; at t > 0 the geometry must actually move.
    from terminal_raytracer.models.animate import ANIMATOR_KEYS, orbit

    cfg = json.loads((_SCENES / "Cornell_Box.json").read_text())
    cfg["spheres"][1].update(transparency=0.95, ior=1.5, color=[1, 1, 1])
    cfg["planes"][0].update(checker_color=[0.1, 0.1, 0.1],
                            checker_scale=2.0)
    cfg["spheres"][2].update(roughness=0.3)
    cfg.update(width=48, height=12, samples_per_pixel=4, max_depth=4)
    scene = sm.scene_from_dict(cfg)
    cur, _var, tot, rays = _render(PathTracer(scene), seed=9)
    t_dyn = PathTracer(scene, dynamic=True,
                       dyn_animated=ANIMATOR_KEYS["orbit"])
    a0 = dyn_mod.pack_scene(scene)
    step = jax.jit(lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a))
    c2, _v2, t2, r2 = step(POSE, np.uint32(9), np.int32(0), orbit(a0, 0.0))
    np.testing.assert_array_equal(np.asarray(t2), np.asarray(tot))
    assert float(r2) == float(rays)
    for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c3, *_ = step(POSE, np.uint32(9), np.int32(0), orbit(a0, 2.0))
    assert not np.array_equal(np.asarray(c3.x), np.asarray(cur.x))


def test_pallas_schedulers_match_oracle_on_showcase_scene():
    # The packaged showcase scene exercises every extension channel at
    # once (checker floor + glass + brushed metal) through the GPU
    # kernel. Checker cell boundaries are knife-edges: a 1-ulp
    # cross-program difference in the hit position can flip an isolated
    # boundary pixel's cell parity (ops/tracer.py comment) — so radiance
    # is compared outlier-tolerantly (boundary flips are O(1) color
    # changes on <= a handful of pixels), while decisions stay EXACT:
    # max_depth 4 keeps Russian roulette off, so the recolor cannot feed
    # back into control flow.
    scene = load_scene("showcase").with_overrides(
        width=128, height=8, samples_per_pixel=4, max_depth=4
    )
    assert (scene.has_checker and scene.has_dielectrics
            and scene.has_rough_metals)
    cur_o, _vo, tot_o, rays_o = _render(PathTracer(scene))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(
        POSE, np.uint32(42), np.int32(0)
    )
    err = "kernel"
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o),
                                  err)
    assert float(rays_p) == float(rays_o), err
    for a, b in ((cur_p.x, cur_o.x), (cur_p.y, cur_o.y),
                 (cur_p.z, cur_o.z)):
        diff = np.abs(np.asarray(a) - np.asarray(b))
        outliers = int((diff > 2e-5).sum())
        assert outliers <= diff.size // 100, (err, outliers)
        assert np.median(diff) < 2e-6, (err, float(np.median(diff)))
