"""Image textures — capability extension (the reference's materials end at
``reflectivity``, reference: src/lib.rs:73-98; its only texture-shaped code
is nothing at all — even the checker extension here is already a superset).

Design: a texture is a small, fixed-resolution texel table in one packed
(rows, 128) atlas, fetched per lane (ops/tracer.gather_texels: a direct
indexed load in the GPU kernel, a row sweep on the XLA path, whose cost
grows with the rows). Every texture in a scene is resampled at load time to
one power-of-two resolution S (``texture_size``, default 32), each texture
occupying ``S*S/128`` aligned rows of a single packed atlas.

Texels are packed 8-bit RGB in one i32 (``r<<16 | g<<8 | b``) — one fetch
instead of three, unpacked with shifts/ands. 8-bit is the fidelity of the source formats (PPM,
inline JSON ints); quantizing at load keeps the jnp oracle and the GPU
kernel reading bit-identical texel values.

Row order: texel rows are stored BOTTOM-UP (v=0 first), so the v
coordinate indexes rows directly without a flip at trace time.

Scene JSON (schema superset, inert when absent):

    "textures": {"bricks": {"file": "bricks.ppm"},
                 "mini":   {"pixels": [[[255,0,0],[0,255,0]],
                                       [[0,0,255],[255,255,255]]]}},
    ...
    "planes": [{..., "texture": "bricks", "texture_scale": 0.5}]

``file`` is a binary PPM (P6) or an 8-bit truecolor PNG (by suffix),
resolved relative to the scene file;
``pixels`` is rows-of-[r,g,b] ints in [0,255], row 0 = TOP row (image
order, flipped to bottom-up at pack time). Mapping is chosen by primitive
kind: spheres get spherical (latitude/longitude of the hit normal),
planes/triangles get dominant-axis planar projection of the world-space
hit point (ops/tracer.py).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Tuple

import numpy as np

__all__ = [
    "Texture",
    "texture_from_spec",
    "build_atlas",
    "LANES",
    "DEFAULT_SIZE",
    "MAX_ATLAS_ROWS",
]

LANES = 128  # atlas row width (ROADMAP R3 lifts the format)
DEFAULT_SIZE = 32
_ALLOWED_SIZES = (16, 32, 64, 128)
# Atlas cap: 512 rows = 64 KiB as i32. The XLA path's row-sweep fetch
# costs O(rows) per iteration, so this also bounds its trace cost (R3).
MAX_ATLAS_ROWS = 512


class Texture(NamedTuple):
    """One loaded texture: hashable (Scene is a jit static argument), texels
    packed ``r<<16|g<<8|b``, row-major BOTTOM-UP (v=0 row first)."""

    name: str
    size: int
    texels: Tuple[int, ...]  # length size*size

    @property
    def rows(self) -> int:
        """Aligned atlas rows this texture occupies."""
        return max(1, (self.size * self.size) // LANES)


def _pack_rgb(img: np.ndarray) -> Tuple[int, ...]:
    """[S, S, 3] uint8 (row 0 = top) -> bottom-up packed i32 tuple."""
    img = img[::-1].astype(np.int64)
    packed = (img[..., 0] << 16) | (img[..., 1] << 8) | img[..., 2]
    return tuple(int(v) for v in packed.reshape(-1))


def _resample_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor resample of [H, W, 3] uint8 to [size, size, 3]."""
    h, w = img.shape[:2]
    ys = np.minimum((np.arange(size) + 0.5) * h / size, h - 1).astype(int)
    xs = np.minimum((np.arange(size) + 0.5) * w / size, w - 1).astype(int)
    return img[ys][:, xs]


def texture_from_spec(name: str, spec: dict, base_dir=None,
                      size: int = DEFAULT_SIZE) -> Texture:
    """Build one Texture from its scene-JSON spec (module docstring)."""
    if not isinstance(spec, dict):
        raise ValueError(
            f"texture {name!r} spec must be an object with 'file' or "
            f"'pixels', got {type(spec).__name__}"
        )
    if size not in _ALLOWED_SIZES:
        raise ValueError(
            f"texture_size must be one of {_ALLOWED_SIZES}, got {size!r}"
        )
    if ("file" in spec) == ("pixels" in spec):
        raise ValueError(
            f"texture {name!r} needs exactly one of 'file' or 'pixels'"
        )
    if "file" in spec:
        from ..utils import imageio

        path = Path(spec["file"])
        if not path.is_absolute() and base_dir is not None:
            path = Path(base_dir) / path
        if not path.exists():
            raise FileNotFoundError(
                f"texture {name!r}: no such file {str(path)!r}"
            )
        if path.suffix.lower() == ".png":
            img = imageio.read_png(path)
        else:
            img = imageio.read_ppm(path)
    else:
        img = np.asarray(spec["pixels"])
        if img.ndim != 3 or img.shape[2] != 3 or img.size == 0:
            raise ValueError(
                f"texture {name!r} pixels must be a non-empty "
                f"rows x cols x [r,g,b] array, got shape {img.shape}"
            )
        if img.min() < 0 or img.max() > 255:
            raise ValueError(
                f"texture {name!r} pixel components must be ints in "
                f"[0, 255], got range [{img.min()}, {img.max()}]"
            )
        img = img.astype(np.uint8)
    return Texture(name=str(name), size=size,
                   texels=_pack_rgb(_resample_nearest(img, size)))


def build_atlas(textures: Tuple[Texture, ...]) -> np.ndarray:
    """Stack textures into the packed (rows, LANES) i32 atlas the tracer
    gathers from. Texture k (1-based id k+1... ids are positional: index i
    in this tuple is id i+1) starts at row i * textures[0].rows — all
    textures in a scene share one size (validated at Scene construction).
    """
    if not textures:
        return np.zeros((1, LANES), np.int32)
    rows = sum(t.rows for t in textures)
    atlas = np.zeros((rows, LANES), np.int32)
    r0 = 0
    for t in textures:
        flat = np.asarray(t.texels, np.int64).astype(np.int32)
        atlas[r0:r0 + t.rows] = flat.reshape(t.rows, LANES)
        r0 += t.rows
    return atlas
