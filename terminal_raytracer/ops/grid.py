"""Uniform-grid spatial acceleration structure (CSR), vectorized NumPy.

Parity context (SURVEY.md §2.4): the reference *builds and uploads* a
uniform grid (reference: src/lib.rs:158-246, bindings 5/6 at lib.rs:334-335)
but its shader never declares those bindings — traversal is brute-force
linear (shader.wgsl:254). The capability exists here as the same build-time
artifact — scene AABB, heuristic resolution s = n^(1/3) * 1.5, per-cell
primitive buckets flattened to CSR offsets/indices — produced by vectorized
NumPy instead of nested host loops, and exported as SoA arrays a future
grid-traversal kernel can consume. It ships **off by default**, matching
the reference's effective behavior (shipped scenes are <= ~30 primitives,
where the brute sweep wins anyway).

Semantics matched to lib.rs:158-246: sphere AABB = center +- r; triangle
AABB = vertex min/max; planes (and any unknown type) get the degenerate
(0,0,0) AABB — the reference's quirk at lib.rs:177 — and are therefore
bucketed only into the cell containing the origin; bbox padded by 1e-3;
per-axis resolution proportional to extent, >= 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..models import scene as scene_mod

PAD = 1e-3
RESOLUTION_FACTOR = 1.5  # s = n^(1/3) * 1.5 (lib.rs:198)


class UniformGrid(NamedTuple):
    grid_min: np.ndarray  # (3,) f32
    inv_cell_size: np.ndarray  # (3,) f32
    dims: np.ndarray  # (3,) i32: nx, ny, nz
    offsets: np.ndarray  # (nx*ny*nz + 1,) i32 CSR row offsets
    indices: np.ndarray  # (nnz,) i32 primitive indices

    @property
    def cell_count(self) -> int:
        return int(np.prod(self.dims))

    def cell_primitives(self, ix: int, iy: int, iz: int) -> np.ndarray:
        nx, ny, _ = self.dims
        ci = ix + iy * nx + iz * nx * ny
        return self.indices[self.offsets[ci] : self.offsets[ci + 1]]


def primitive_aabbs(scene: scene_mod.Scene) -> np.ndarray:
    """(N, 2, 3) min/max AABBs in the reference's flatten order."""
    boxes = []
    for tag, p in scene.primitives:
        if tag == scene_mod.SPHERE:
            c = np.asarray(p.center, np.float32)
            r = np.float32(p.radius)
            boxes.append((c - r, c + r))
        elif tag == scene_mod.TRIANGLE:
            v = np.stack([p.v0, p.v1, p.v2]).astype(np.float32)
            boxes.append((v.min(0), v.max(0)))
        else:  # plane: degenerate zero AABB (lib.rs:177)
            z = np.zeros(3, np.float32)
            boxes.append((z, z))
    return np.asarray(boxes, np.float32).reshape(-1, 2, 3)


def build_uniform_grid(scene: scene_mod.Scene,
                       factor: float = RESOLUTION_FACTOR) -> UniformGrid:
    """`factor` scales the resolution heuristic s = n^(1/3) * factor —
    default matches the reference (lib.rs:198); the gathered traversal
    (ops/gathered.py) picks its own measured optimum."""
    boxes = primitive_aabbs(scene)
    n = len(boxes)
    if n == 0:
        return UniformGrid(
            grid_min=np.zeros(3, np.float32),
            inv_cell_size=np.ones(3, np.float32),
            dims=np.ones(3, np.int32),
            offsets=np.zeros(2, np.int32),
            indices=np.zeros(0, np.int32),
        )

    bmin = boxes[:, 0].min(0) - PAD
    bmax = boxes[:, 1].max(0) + PAD
    extent = bmax - bmin

    s = n ** (1.0 / 3.0) * factor
    longest = max(float(extent.max()), 1e-12)
    dims = np.maximum(1, np.rint(s * extent / longest).astype(np.int64))
    cell = extent / dims
    cell = np.where(cell <= 0, 1.0, cell)

    # Per-primitive cell ranges (inclusive), clamped.
    lo = np.clip(np.floor((boxes[:, 0] - bmin) / cell).astype(np.int64), 0, dims - 1)
    hi = np.clip(np.floor((boxes[:, 1] - bmin) / cell).astype(np.int64), 0, dims - 1)

    # Vectorized bucketing: expand each primitive's (lo..hi) box of cells.
    counts = (hi - lo + 1).prod(axis=1)
    prim_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
    # local offsets within each primitive's cell box
    local = np.concatenate([np.arange(c, dtype=np.int64) for c in counts])
    span = hi - lo + 1
    span_rep = np.repeat(span, counts, axis=0)
    lo_rep = np.repeat(lo, counts, axis=0)
    cx = lo_rep[:, 0] + local % span_rep[:, 0]
    cy = lo_rep[:, 1] + (local // span_rep[:, 0]) % span_rep[:, 1]
    cz = lo_rep[:, 2] + local // (span_rep[:, 0] * span_rep[:, 1])
    cell_ids = cx + cy * dims[0] + cz * dims[0] * dims[1]

    # CSR, cells in x-major order (lib.rs:227), stable by primitive index.
    order = np.lexsort((prim_ids, cell_ids))
    sorted_cells = cell_ids[order]
    n_cells = int(dims.prod())
    offsets = np.zeros(n_cells + 1, np.int64)
    np.add.at(offsets, sorted_cells + 1, 1)
    offsets = np.cumsum(offsets)

    return UniformGrid(
        grid_min=bmin.astype(np.float32),
        inv_cell_size=(1.0 / cell).astype(np.float32),
        dims=dims.astype(np.int32),
        offsets=offsets.astype(np.int32),
        indices=prim_ids[order].astype(np.int32),
    )
