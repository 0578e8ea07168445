"""Uniform-grid builder tests: semantics matched to the reference's
build_uniform_grid (reference: src/lib.rs:158-246) — verified against a
naive per-primitive loop, plus invariants on the shipped scenes."""

import numpy as np
import pytest

from terminal_raytracer.models import load_scene
from terminal_raytracer.models.scene import scene_from_dict
from terminal_raytracer.ops.grid import build_uniform_grid, primitive_aabbs


def _naive_grid_cells(scene, grid):
    """Reference-style nested-loop bucketing for comparison."""
    boxes = primitive_aabbs(scene)
    dims = grid.dims
    cell = 1.0 / grid.inv_cell_size
    buckets = {i: [] for i in range(grid.cell_count)}
    for idx, (mn, mx) in enumerate(boxes):
        lo = np.clip(np.floor((mn - grid.grid_min) / cell).astype(int), 0, dims - 1)
        hi = np.clip(np.floor((mx - grid.grid_min) / cell).astype(int), 0, dims - 1)
        for z in range(lo[2], hi[2] + 1):
            for y in range(lo[1], hi[1] + 1):
                for x in range(lo[0], hi[0] + 1):
                    buckets[x + y * dims[0] + z * dims[0] * dims[1]].append(idx)
    return buckets


@pytest.mark.parametrize("name", ["Cornell_Box", "demo", "scene2"])
def test_matches_naive_bucketing(name):
    scene = load_scene(name)
    grid = build_uniform_grid(scene)
    naive = _naive_grid_cells(scene, grid)
    assert len(grid.offsets) == grid.cell_count + 1
    assert grid.offsets[0] == 0 and grid.offsets[-1] == len(grid.indices)
    for ci in range(grid.cell_count):
        got = list(grid.indices[grid.offsets[ci] : grid.offsets[ci + 1]])
        assert got == naive[ci], f"cell {ci}"


def test_sphere_fully_covered():
    """Every cell overlapping a sphere's AABB lists that sphere."""
    cfg = {
        "width": 4, "height": 4, "samples_per_pixel": 1, "max_depth": 1,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 1.0},
        "spheres": [
            {"center": [0, 0, 0], "radius": 1.0, "color": [1, 1, 1],
             "emission": [0, 0, 0], "reflectivity": 0.0},
            {"center": [4, 0, 0], "radius": 0.5, "color": [1, 1, 1],
             "emission": [0, 0, 0], "reflectivity": 0.0},
        ],
        "planes": [],
    }
    scene = scene_from_dict(cfg)
    grid = build_uniform_grid(scene)
    # Both spheres appear somewhere; membership counts >= 1 each
    assert set(grid.indices) == {0, 1}
    # Point lookup: the cell containing each center lists that sphere.
    for i, center in enumerate([(0, 0, 0), (4, 0, 0)]):
        c = np.array(center, np.float32)
        ci = np.clip(
            np.floor((c - grid.grid_min) * grid.inv_cell_size).astype(int),
            0, grid.dims - 1,
        )
        prims = grid.cell_primitives(*ci)
        assert i in prims


def test_planes_degenerate_aabb():
    """Planes get the reference's (0,0,0) AABB quirk (lib.rs:177)."""
    scene = load_scene("Cornell_Box")
    boxes = primitive_aabbs(scene)
    # primitives 3..8 are the six planes
    np.testing.assert_array_equal(boxes[3:9], 0.0)


def test_empty_scene():
    cfg = {
        "width": 4, "height": 4, "samples_per_pixel": 1, "max_depth": 1,
        "frames_to_accumulate": 1,
        "camera": {"fov_degrees": 45.0, "char_aspect_ratio": 1.0},
        "spheres": [], "planes": [],
    }
    grid = build_uniform_grid(scene_from_dict(cfg))
    assert grid.cell_count == 1 and len(grid.indices) == 0
