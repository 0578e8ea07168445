"""Image textures — capability extension tests.

`texture` + `texture_scale` sample a per-scene texel atlas at hits
(ops/tracer.py _texture_recolor): spherical mapping on spheres, dominant-
axis planar on planes/triangles, texels fetched per lane
(tracer.gather_texels). Same contract
as the other extension channels (test_checker / test_dielectric):
statically gated — scenes without textures compile to the exact
pre-extension program — and agreeing across every traversal and scheduler.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from terminal_raytracer.models import Camera, load_scene
from terminal_raytracer.models import scene as sm
from terminal_raytracer.models import texture as tx
from terminal_raytracer.ops import dynamic as dyn_mod
from terminal_raytracer.ops import pallas_kernel
from terminal_raytracer.ops import sampling
from terminal_raytracer.ops.tracer import PathTracer, gather_texels

POSE = Camera().pose()

_SCENES = Path(sm.__file__).parent / "scenes"

# 2x2 quad texture: red/green top row, blue/white bottom row (image order).
_QUAD = {"pixels": [[[255, 0, 0], [0, 255, 0]],
                    [[0, 0, 255], [255, 255, 255]]]}


def _textured_scene(**overrides):
    """Emissive sky + textured floor plane + textured sphere, tiny."""
    cfg = {
        "width": 128, "height": 8, "samples_per_pixel": 4, "max_depth": 3,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "texture_size": 16,
        "textures": {"quad": _QUAD},
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [1, 1, 1], "emission": [0, 0, 0],
                    "reflectivity": 0.0,
                    "texture": "quad", "texture_scale": 0.5}],
        "spheres": [{"center": [0, 5, -3], "radius": 1.0,
                     "color": [0, 0, 0], "emission": [10, 10, 10],
                     "reflectivity": 0.0},
                    {"center": [0, 0, -3], "radius": 1.0,
                     "color": [1, 1, 1], "emission": [0, 0, 0],
                     "reflectivity": 0.0, "texture": "quad"}],
    }
    cfg.update(overrides)
    return sm.scene_from_dict(cfg)


def _render(tracer, seed=42, frame=0):
    return jax.jit(tracer.render_frame)(POSE, np.uint32(seed),
                                        np.int32(frame))


# ---------------------------------------------------------------------------
# Schema / loader / atlas units
# ---------------------------------------------------------------------------


def test_schema_and_static_gate():
    m = sm.Material(color=(1, 1, 1), emission=(0, 0, 0), reflectivity=0.0)
    assert m.texture is None and not m.is_textured
    s = _textured_scene()
    assert s.planes[0].material.is_textured and s.has_texture
    assert s.texture_index("quad") == 1 and s.texture_index(None) == 0
    # Signed mapping ids: sphere -> spherical (negative), plane -> planar.
    assert s.texture_channel(sm.SPHERE, s.spheres[1].material) == (-1.0, 1.0)
    ti, ts = s.texture_channel(sm.PLANE, s.planes[0].material)
    assert (ti, ts) == (1.0, 0.5)
    plain = load_scene("Cornell_Box")
    assert not plain.has_texture
    assert not any(k.endswith(("_txi", "_txs"))
                   for k, _ in dyn_mod.scene_keys(plain))
    assert {"p_txi", "p_txs", "s_txi", "s_txs"} <= {
        k for k, _ in dyn_mod.scene_keys(s)
    }


def test_loader_validation():
    base = {
        "width": 8, "height": 8, "samples_per_pixel": 1, "max_depth": 1,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 60.0, "char_aspect_ratio": 1.0},
        "textures": {"quad": copy.deepcopy(_QUAD)},
        "planes": [{"point": [0, -1, 0], "normal": [0, 1, 0],
                    "color": [1, 1, 1], "emission": [0, 0, 0],
                    "reflectivity": 0.0, "texture": "quad"}],
    }
    # unknown texture name
    bad = copy.deepcopy(base)
    bad["planes"][0]["texture"] = "nope"
    with pytest.raises(ValueError, match="nope"):
        sm.scene_from_dict(bad)
    # texture_scale without texture
    bad = copy.deepcopy(base)
    del bad["planes"][0]["texture"]
    bad["planes"][0]["texture_scale"] = 2.0
    with pytest.raises(ValueError, match="texture_scale"):
        sm.scene_from_dict(bad)
    # zero scale
    bad = copy.deepcopy(base)
    bad["planes"][0]["texture_scale"] = 0.0
    with pytest.raises(ValueError, match="texture_scale"):
        sm.scene_from_dict(bad)
    # both file and pixels
    bad = copy.deepcopy(base)
    bad["textures"]["quad"]["file"] = "x.ppm"
    with pytest.raises(ValueError, match="exactly one"):
        sm.scene_from_dict(bad)
    # out-of-range pixel values
    bad = copy.deepcopy(base)
    bad["textures"]["quad"] = {"pixels": [[[300, 0, 0]]]}
    with pytest.raises(ValueError, match="255"):
        sm.scene_from_dict(bad)
    # bad texture_size
    bad = copy.deepcopy(base)
    bad["texture_size"] = 24
    with pytest.raises(ValueError, match="texture_size"):
        sm.scene_from_dict(bad)


def test_atlas_packing_and_ppm_roundtrip(tmp_path):
    from terminal_raytracer.utils import imageio

    # PPM file -> Texture equals the same pixels inline.
    img = np.arange(16 * 16 * 3, dtype=np.uint32).reshape(16, 16, 3) % 256
    img = img.astype(np.uint8)
    imageio.write_ppm(tmp_path / "t.ppm", img)
    t_file = tx.texture_from_spec("t", {"file": "t.ppm"},
                                  base_dir=tmp_path, size=16)
    t_inline = tx.texture_from_spec("t", {"pixels": img.tolist()}, size=16)
    assert t_file == t_inline
    # Bottom-up packing: texel (iv=0, iu=0) is the image's BOTTOM-left.
    bl = img[-1, 0]
    assert t_file.texels[0] == (int(bl[0]) << 16 | int(bl[1]) << 8
                                | int(bl[2]))
    # Atlas stacking: texture k starts at row k * rows.
    t2 = tx.texture_from_spec("u", {"pixels": img.tolist()}, size=16)
    atlas = tx.build_atlas((t_file, t2))
    assert atlas.shape == (4, 128) and atlas.dtype == np.int32
    np.testing.assert_array_equal(atlas[0:2], atlas[2:4])
    flat = np.asarray(t_file.texels, np.int64).astype(np.int32)
    np.testing.assert_array_equal(atlas[0:2].reshape(-1), flat)


def test_gather_texels_matches_flat_indexing():
    rng = np.random.default_rng(3)
    tab = rng.integers(0, 1 << 24, size=(6, 128)).astype(np.int32)
    idx = rng.integers(0, 6 * 128, size=(16, 128)).astype(np.int32)
    got = np.asarray(jax.jit(
        lambda t, i: gather_texels(t, i, 6)
    )(jnp.asarray(tab), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, tab.reshape(-1)[idx])


def test_atan2_accuracy():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(5000).astype(np.float32).reshape(50, 100) * 3
    x = rng.standard_normal(5000).astype(np.float32).reshape(50, 100) * 3
    got = np.asarray(jax.jit(sampling.atan2)(jnp.asarray(y),
                                             jnp.asarray(x)))
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=5e-6)
    # axis cases the uv mapping hits
    assert float(jax.jit(sampling.atan2)(jnp.float32(0), jnp.float32(0))) == 0


# ---------------------------------------------------------------------------
# Render behavior
# ---------------------------------------------------------------------------


def test_texture_visible_on_floor():
    # The floor's first-bounce image must contain all three distinct quad
    # colors in patches (planar mapping tiles them in world space).
    scene = _textured_scene(max_depth=2)
    cur, *_ = _render(PathTracer(scene))
    r, g, b = (np.asarray(cur.x), np.asarray(cur.y), np.asarray(cur.z))
    floor = slice(5, 8)  # bottom rows look down at the plane
    red = int(((r[floor] > 2 * g[floor]) & (r[floor] > 2 * b[floor])).sum())
    green = int(((g[floor] > 2 * r[floor]) & (g[floor] > 2 * b[floor])).sum())
    blue = int(((b[floor] > 2 * r[floor]) & (b[floor] > 2 * g[floor])).sum())
    assert red > 5 and green > 5 and blue > 5, (red, green, blue)


def test_spherical_mapping_wraps_the_sphere():
    # A 1-texel-wide vertical stripe texture on a sphere must appear as
    # bands varying with longitude, not a planar projection: rotate the
    # camera-facing hemisphere's u range and check multiple distinct
    # colors appear across the sphere's visible face.
    stripe = {"pixels": [[[255, 0, 0] if j < 8 else [0, 0, 255]
                          for j in range(16)] for _ in range(16)]}
    scene = _textured_scene(textures={"quad": stripe}, max_depth=2)
    cur, *_ = _render(PathTracer(scene))
    r, b = np.asarray(cur.x), np.asarray(cur.z)
    face = (slice(2, 6), slice(48, 80))  # the sphere's visible face
    red = int((r[face] > 2 * b[face]).sum())
    blue = int((b[face] > 2 * r[face]).sum())
    assert red > 3 and blue > 3, (red, blue)


def test_traversals_agree_on_textured_scene():
    scene = _textured_scene(width=64, height=16, samples_per_pixel=4,
                            max_depth=3)
    cur, _var, tot, rays = _render(PathTracer(scene))
    for accel in ("array", "grid"):
        c2, _v2, t2, r2 = _render(PathTracer(scene, accel=accel))
        for a, b in ((c2.x, cur.x), (c2.y, cur.y), (c2.z, cur.z)):
            if accel == "array":
                # the documented XLA-CPU FMA ulp (ops/arrayscene._fori)
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


def test_pallas_schedulers_match_oracle_on_textured_scene():
    # Texel-grid boundaries are knife-edges exactly like checker cells
    # (ops/tracer.py _texture_recolor): radiance is compared
    # outlier-tolerantly while decisions (ray counts, budgets) stay EXACT —
    # max_depth 3 keeps Russian roulette off so the recolor cannot feed
    # back into control flow.
    scene = _textured_scene()
    cur_o, _vo, tot_o, rays_o = _render(PathTracer(scene))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42),
                                         np.int32(0))
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


def test_dynamic_pallas_and_animator_folding():
    # The GPU kernel under dynamic values with the texel atlas
    # operand, and animator-key folding composed with the texture channels
    # (orbit animates geometry; txi/txs fold back to constants).
    from terminal_raytracer.models.animate import ANIMATOR_KEYS, orbit

    # Textured sphere OFF the scene's centroid axis, so the orbit
    # animation actually displaces it.
    scene = _textured_scene(spheres=[
        {"center": [0, 5, -3], "radius": 1.0, "color": [0, 0, 0],
         "emission": [10, 10, 10], "reflectivity": 0.0},
        {"center": [0.9, 0, -3], "radius": 1.0, "color": [1, 1, 1],
         "emission": [0, 0, 0], "reflectivity": 0.0, "texture": "quad"},
    ])
    cur_o, _vo, tot_o, rays_o = _render(PathTracer(scene), seed=9)
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True,
                                                 dynamic=True))
    a0 = dyn_mod.pack_scene(scene)
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(9), np.int32(0),
                                         a0)
    assert float(rays_p) == float(rays_o)
    np.testing.assert_array_equal(np.asarray(tot_p), np.asarray(tot_o))
    t_dyn = PathTracer(scene, dynamic=True,
                       dyn_animated=ANIMATOR_KEYS["orbit"])
    step = jax.jit(lambda p, s, f, a: t_dyn.render_frame_dynamic(p, s, f, a))
    c2, _v2, t2, r2 = step(POSE, np.uint32(9), np.int32(0), orbit(a0, 0.0))
    assert float(r2) == float(rays_o)
    for a, b in ((c2.x, cur_o.x), (c2.y, cur_o.y), (c2.z, cur_o.z)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    c3, *_ = step(POSE, np.uint32(9), np.int32(0), orbit(a0, 2.0))
    assert not np.array_equal(np.asarray(c3.x), np.asarray(cur_o.x))


def test_packaged_textured_scene():
    scene = load_scene("textured")
    assert scene.has_texture and len(scene.textures) == 2
    assert scene.texture_size == 64 and scene.texture_rows == 32
    small = scene.with_overrides(width=48, height=12, samples_per_pixel=2,
                                 max_depth=2)
    cur, *_ = _render(PathTracer(small))
    assert np.isfinite(np.asarray(cur.x)).all()


def test_untextured_scene_pays_nothing():
    # The static gate: an untextured tracer has no atlas machinery at all
    # (no operand, no gather — the kernel's inputs stay unchanged).
    scene = load_scene("Cornell_Box").with_overrides(
        width=32, height=8, samples_per_pixel=1, max_depth=2)
    tracer = PathTracer(scene)
    assert not tracer.has_texture
    assert pallas_kernel._table_ops(tracer) == ()


# ---------------------------------------------------------------------------
# Bilinear magnification filter (texture_filter='bilinear')
# ---------------------------------------------------------------------------


def test_bilinear_gate_and_validation():
    assert not _textured_scene().tex_bilinear  # default: nearest
    assert _textured_scene(texture_filter="bilinear").tex_bilinear
    with pytest.raises(ValueError, match="texture_filter"):
        _textured_scene(texture_filter="cubic")


def test_bilinear_equals_nearest_on_constant_texture():
    # All four blended texels are equal, so the lerp is exact — the whole
    # render (colors, ray counts, budgets) must match nearest bit-for-bit.
    flat = {"pixels": [[[200, 100, 50]] * 4] * 4}
    cn = _render(PathTracer(_textured_scene(textures={"quad": flat})))
    cb = _render(PathTracer(_textured_scene(textures={"quad": flat},
                                            texture_filter="bilinear")))
    for a, b in zip(cn[0], cb[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(cn[2]), np.asarray(cb[2]))
    assert float(cn[3]) == float(cb[3])


def test_bilinear_fetch_matches_numpy_reference():
    # The raw filtered fetch vs an independent numpy bilinear-with-wrap:
    # texel centers at (i+0.5)/S, all edges wrap (tracer._fetch_bilinear).
    scene = _textured_scene(texture_filter="bilinear")
    t = PathTracer(scene)
    S = t.tex_size
    rng = np.random.default_rng(7)
    u = rng.random((16, 128), np.float32)
    v = rng.random((16, 128), np.float32)
    got = jax.jit(
        lambda uu, vv: t._fetch_bilinear(0, uu, vv, 0, t.tex_rows)
    )(jnp.asarray(u), jnp.asarray(v))
    atlas = np.asarray(t.tex_atlas_host).reshape(-1)[:S * S]
    tex = np.stack([(atlas >> 16) & 255, (atlas >> 8) & 255, atlas & 255],
                   axis=-1).reshape(S, S, 3).astype(np.float32) / 255.0
    x = u.astype(np.float64) * S - 0.5
    y = v.astype(np.float64) * S - 0.5
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0).astype(np.float32), (y - y0).astype(np.float32)
    iu0, iv0 = x0 & (S - 1), y0 & (S - 1)
    iu1, iv1 = (iu0 + 1) & (S - 1), (iv0 + 1) & (S - 1)
    t00, t01 = tex[iv0, iu0], tex[iv0, iu1]
    t10, t11 = tex[iv1, iu0], tex[iv1, iu1]
    fx, fy = fx[..., None], fy[..., None]
    want = (t00 + (t01 - t00) * fx) * (1 - fy) + (t10 + (t11 - t10) * fx) * fy
    for c, ch in enumerate((got.x, got.y, got.z)):
        np.testing.assert_allclose(np.asarray(ch), want[..., c],
                                   rtol=2e-5, atol=2e-6)


def test_bilinear_smooths_texel_edges():
    # Across one texel row of a 2-color stripe texture, nearest jumps in
    # one step; bilinear produces intermediate values.
    stripe = {"pixels": [[[255, 0, 0] if j < 8 else [0, 0, 255]
                          for j in range(16)] for _ in range(16)]}
    scene = _textured_scene(textures={"quad": stripe},
                            texture_filter="bilinear")
    t = PathTracer(scene)
    u = jnp.asarray(np.linspace(0.3, 0.7, 128, dtype=np.float32)[None, :])
    v = jnp.full((1, 128), 0.5, jnp.float32)
    got = np.asarray(jax.jit(
        lambda uu, vv: t._fetch_bilinear(0, uu, vv, 0, t.tex_rows).x
    )(u, v))[0]
    mid = (got > 0.2) & (got < 0.8)
    assert mid.sum() >= 4, "no blended samples across the stripe edge"
    assert got[0] > 0.9 and got[-1] < 0.1


def test_bilinear_pallas_schedulers_match_oracle():
    scene = _textured_scene(texture_filter="bilinear")
    cur_o, _vo, tot_o, rays_o = _render(PathTracer(scene))
    pf = jax.jit(pallas_kernel.make_render_frame(scene, interpret=True))
    cur_p, _vp, tot_p, rays_p, _occ = pf(POSE, np.uint32(42),
                                         np.int32(0))
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


def test_bilinear_sky():
    # The sky fetch takes the same filtered path (scene-level static).
    import copy as _copy

    from tests.test_sky import _sky_scene, _WHITE

    scene = _sky_scene(textures={"quad": _copy.deepcopy(_WHITE)},
                       sky={"texture": "quad", "intensity": 1.5},
                       samples_per_pixel=4, texture_filter="bilinear")
    assert scene.tex_bilinear and scene.has_sky_texture
    cur, *_ = _render(PathTracer(scene))
    a = np.asarray(cur.x)
    assert (a == a[0, 0]).all()
    np.testing.assert_allclose(a, 1.5, rtol=2e-7)


# ---------------------------------------------------------------------------
# PNG texture files (stdlib reader, utils/imageio.read_png)
# ---------------------------------------------------------------------------


def test_read_png_roundtrip_and_filters(tmp_path):
    from terminal_raytracer.utils import imageio

    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=(24, 17, 3)).astype(np.uint8)
    # our own writer (filter 0 rows)
    imageio.write_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(imageio.read_png(tmp_path / "a.png"), img)
    # an independent encoder picks Sub/Up/Average/Paeth filters per row —
    # exercise the full filter decoder (PIL is a dev-env tool here, not a
    # package dependency)
    PIL = pytest.importorskip("PIL.Image")
    grad = (np.arange(24)[:, None, None] * 10
            + np.arange(17)[None, :, None] * 5
            + np.arange(3)[None, None, :]) % 256
    for arr in (img, grad.astype(np.uint8)):
        PIL.fromarray(arr).save(tmp_path / "b.png", optimize=True)
        np.testing.assert_array_equal(imageio.read_png(tmp_path / "b.png"),
                                      arr)
        # RGBA: alpha dropped
        rgba = np.concatenate([arr, np.full((24, 17, 1), 200, np.uint8)],
                              axis=-1)
        PIL.fromarray(rgba, "RGBA").save(tmp_path / "c.png")
        np.testing.assert_array_equal(imageio.read_png(tmp_path / "c.png"),
                                      arr)


def test_read_png_rejects_unsupported(tmp_path):
    from terminal_raytracer.utils import imageio

    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        imageio.read_png(tmp_path / "x.png")
    PIL = pytest.importorskip("PIL.Image")
    pal = PIL.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P")
    pal.save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="color type"):
        imageio.read_png(tmp_path / "p.png")


def test_png_texture_in_scene(tmp_path):
    from terminal_raytracer.utils import imageio

    img = np.zeros((16, 16, 3), np.uint8)
    img[:8] = (255, 0, 0)
    img[8:] = (0, 0, 255)
    imageio.write_png(tmp_path / "t.png", img)
    imageio.write_ppm(tmp_path / "t.ppm", img)
    t_png = tx.texture_from_spec("t", {"file": "t.png"},
                                 base_dir=tmp_path, size=16)
    t_ppm = tx.texture_from_spec("t", {"file": "t.ppm"},
                                 base_dir=tmp_path, size=16)
    assert t_png.texels == t_ppm.texels  # byte-identical load paths
