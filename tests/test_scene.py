"""Scene schema tests: the packaged JSONs parse to the same primitive
counts/values as the reference's flattening (reference: src/lib.rs:120-154),
including optional `triangles` (lib.rs:62-63) and f64->f32 narrowing."""

import numpy as np
import pytest

from terminal_raytracer.models import scene as sm


def test_cornell_counts_and_values():
    s = sm.load_scene("Cornell_Box")
    assert (s.width, s.height) == (400, 200)
    assert s.samples_per_pixel == 128 and s.max_depth == 3
    assert s.frames_to_accumulate == 100000000
    assert len(s.spheres) == 3 and len(s.planes) == 6 and len(s.triangles) == 2
    assert s.primitive_count == 11
    assert s.camera.fov_degrees == 45.0 and s.camera.char_aspect_ratio == np.float32(0.55)
    # Mirror sphere
    mirror = s.spheres[2]
    assert mirror.material.reflectivity == 1.0
    assert mirror.center == (0.0, float(np.float32(0.1)), float(np.float32(-3.2)))
    # Both ceiling triangles are the only lights; planes never light
    lights = s.lights
    assert len(lights) == 2
    assert all(tag == sm.TRIANGLE for tag, _ in lights)
    assert lights[0][1].material.emission == (8.0, 8.0, 8.0)


def test_flatten_order_spheres_planes_triangles():
    s = sm.load_scene("Cornell_Box")
    tags = [tag for tag, _ in s.primitives]
    assert tags == [0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2]


def test_demo_and_scene2():
    demo = sm.load_scene("demo")
    assert demo.max_depth == 32 and demo.samples_per_pixel == 16
    s2 = sm.load_scene("scene2")
    assert len(s2.spheres) == 2 and len(s2.planes) == 1 and len(s2.triangles) == 1
    # scene2's light is the emissive sphere
    assert [tag for tag, _ in s2.lights] == [sm.SPHERE]


def test_triangles_optional():
    cfg = {
        "width": 10, "height": 5, "samples_per_pixel": 1, "max_depth": 1,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 0.5},
        "spheres": [], "planes": [],
    }
    s = sm.scene_from_dict(cfg)
    assert s.triangles == ()


def test_f32_narrowing():
    cfg = {
        "width": 2, "height": 2, "samples_per_pixel": 1, "max_depth": 1,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 0.55},
        "spheres": [{"center": [0.1, 0.2, 0.3], "radius": 0.7,
                     "color": [0.1, 0.1, 0.1], "emission": [0, 0, 0],
                     "reflectivity": 0.3}],
        "planes": [],
    }
    s = sm.scene_from_dict(cfg)
    # 0.1 is not exactly representable; the stored value must be the f32
    # rounding, not the f64 literal.
    assert s.spheres[0].center[0] == float(np.float32(0.1))
    assert s.spheres[0].center[0] != 0.1
    assert s.spheres[0].radius == float(np.float32(0.7))


def test_terminal_clamp():
    s = sm.load_scene("Cornell_Box")
    c = s.clamp_to_terminal(80, 24)
    assert (c.width, c.height) == (80, 22)  # height - 2 status rows
    big = s.clamp_to_terminal(1000, 1000)
    assert (big.width, big.height) == (400, 200)  # never upscales


def test_overrides_are_hashable_static_args():
    s = sm.load_scene("Cornell_Box").with_overrides(samples_per_pixel=4)
    assert s.samples_per_pixel == 4
    hash(s)  # usable as jax.jit static argument
    assert s != sm.load_scene("Cornell_Box")


def test_to_arrays_soa_shapes():
    s = sm.load_scene("Cornell_Box")
    a = s.to_arrays()
    assert a["sphere_center"].shape == (3, 3)
    assert a["sphere_radius"].shape == (3,)
    assert a["plane_point"].shape == (6, 3)
    assert a["triangle_v0"].shape == (2, 3)
    assert a["triangle_emission"].dtype == np.float32
    np.testing.assert_allclose(a["triangle_emission"], 8.0)


def test_missing_scene_error():
    with pytest.raises(FileNotFoundError):
        sm.load_scene("no_such_scene_xyz")


def test_malformed_json_error(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    with pytest.raises(ValueError, match="malformed"):
        sm.load_scene(str(p))


def test_default_scene_is_cornell():
    assert sm.load_scene() == sm.load_scene("Cornell_Box")
    assert sorted(sm.list_scenes()) == ["Cornell_Box", "bumpy",
                                        "cornell_glass", "demo", "envmap",
                                        "mesh_demo", "scene2", "showcase",
                                        "textured"]


def test_scene_validation_rejects_nonsense():
    import pytest

    base = {
        "width": 10, "height": 5, "samples_per_pixel": 1, "max_depth": 1,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 0.55},
        "spheres": [], "planes": [],
    }

    def bad(**kw):
        cfg = dict(base, **kw)
        with pytest.raises(ValueError):
            sm.scene_from_dict(cfg)

    bad(width=1)          # gen_ray divides by width-1
    bad(height=0)
    bad(samples_per_pixel=0)
    bad(max_depth=-3)
    bad(frames_to_accumulate=0)
    bad(camera={"fov_degrees": 0.0, "char_aspect_ratio": 0.55})
    bad(camera={"fov_degrees": 200.0, "char_aspect_ratio": 0.55})
    bad(camera={"fov_degrees": 45.0, "char_aspect_ratio": 0.0})
    mat = {"color": [1, 1, 1], "emission": [0, 0, 0], "reflectivity": 0.0}
    bad(planes=[dict(point=[0, 0, 0], normal=[0, 0, 0], **mat)])
    bad(spheres=[dict(center=[0, 0, 0], radius=0.0, **mat)])
    # with_overrides validates too (CLI --spp 0 etc.)
    s = sm.scene_from_dict(base)
    with pytest.raises(ValueError):
        s.with_overrides(samples_per_pixel=0)
    # clamp_to_terminal floors at 2x2 instead of erroring
    tiny = s.clamp_to_terminal(1, 1)
    assert (tiny.width, tiny.height) == (2, 2)


def test_load_scene_stress_spec():
    from terminal_raytracer.models import load_scene

    s = load_scene("stress:64")
    assert s.primitive_count == 65  # 64 spheres + floor plane
    s2 = load_scene("stress:64:3")
    assert s2.primitive_count == 65
    # different seed -> different geometry
    assert s.spheres[5].center != s2.spheres[5].center
    with pytest.raises(ValueError, match="stress:N"):
        load_scene("stress:abc")
