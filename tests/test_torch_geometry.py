"""Port query-generation geometry (``repro_torch.geometry.queries`` and
``rectilinear``) vs the JAX package's ``repro.geometry``.

Both are numpy only and run the same operations, so the tolerance is
exact equality: bounding boxes and queries field for field on the
reference's fixtures (tests/test_geometry.py), and the rectilinear
helpers on seeded random masks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.geometry as jax_geometry
import repro.geometry.queries as jax_queries
import repro.geometry.rectilinear as jax_rect
import repro_torch.geometry as geometry
import repro_torch.geometry.queries as queries
import repro_torch.geometry.rectilinear as rect
import repro_torch.tracks.segments as segments


def _boxes(mod, **kw):
    return [dataclasses.astuple(b) for b in mod.make_bounding_boxes(**kw)]


@pytest.fixture(scope="module")
def boxes():
    return {"jax": jax_queries.make_bounding_boxes(),
            "port": queries.make_bounding_boxes()}


def test_default_boxes_equal_reference(boxes):
    got = [dataclasses.astuple(b) for b in boxes["port"]]
    want = [dataclasses.astuple(b) for b in boxes["jax"]]
    assert got == want
    # tests/test_geometry.py::test_paper_box_count: the paper's 695.
    assert abs(len(got) - 695) <= 2
    assert [f.name for f in dataclasses.fields(queries.BoundingBox)] \
        == [f.name for f in dataclasses.fields(jax_queries.BoundingBox)]
    assert [b.area_deg2 for b in boxes["port"]] \
        == [b.area_deg2 for b in boxes["jax"]]


@pytest.mark.parametrize("n_days,n_groups", [(196, 64), (1, 64), (3, 7)])
def test_queries_equal_reference(boxes, n_days, n_groups):
    got = queries.generate_queries(boxes["port"], n_days=n_days,
                                   n_groups=n_groups)
    want = jax_queries.generate_queries(boxes["jax"], n_days=n_days,
                                        n_groups=n_groups)
    assert [dataclasses.astuple(q) for q in got] \
        == [dataclasses.astuple(q) for q in want]
    assert len(got) == len(boxes["port"]) * n_days


@pytest.mark.parametrize("kw", [
    dict(cells_per_deg=4, max_cells=6),
    dict(classes=("B", "C"), agl_ceiling_ft=3000.0),
    dict(cells_per_deg=8, max_cells=30, classes=("D",)),
])
def test_boxes_with_options_equal_reference(kw):
    from repro.geometry.aerodromes import synthetic_aerodromes as jax_aero
    from repro_torch.geometry.aerodromes import synthetic_aerodromes
    aero = dict(n=300, seed=5)
    got = _boxes(queries, aerodromes=synthetic_aerodromes(**aero), **kw)
    want = _boxes(jax_queries, aerodromes=jax_aero(**aero), **kw)
    assert got == want and got


def _mask(seed: int, shape=None, p=0.45):
    rng = np.random.default_rng(seed)
    if shape is None:
        shape = (int(rng.integers(1, 24)), int(rng.integers(1, 24)))
    return rng.random(shape) < p


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_decompose_and_split_equal_reference(seed):
    mask = _mask(seed)
    got = rect.decompose_mask_into_rectangles(mask)
    assert got == jax_rect.decompose_mask_into_rectangles(mask)
    assert rect.rectangles_cover_mask(got, mask)
    for max_cells in (1, 4, 12):
        split = rect.split_large_rectangles(got, max_cells)
        assert split == jax_rect.split_large_rectangles(got, max_cells)
        assert rect.rectangles_cover_mask(split, mask)
    bad = got + got[:1]
    assert rect.rectangles_cover_mask(bad, mask) \
        == jax_rect.rectangles_cover_mask(bad, mask)


@pytest.mark.parametrize("seed,p", [(1, 0.4), (3, 0.6), (9, 0.2)])
def test_connected_components_equal_reference(seed, p):
    mask = _mask(seed, shape=(30, 30), p=p)
    got = rect.connected_components(mask)
    want = jax_rect.connected_components(mask)
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    acc = np.sum(got, axis=0)
    assert np.array_equal(acc > 0, mask) and acc.max() <= 1


@pytest.mark.parametrize("lon_scale", [True, False])
def test_rasterize_circles_equal_reference(lon_scale):
    rng = np.random.default_rng(4)
    lats, lons = rng.uniform(25, 48, 20), rng.uniform(-124, -67, 20)
    grid_lat, grid_lon = np.linspace(25, 48, 93), np.linspace(-124, -67, 229)
    got = rect.rasterize_circles(lats, lons, 0.3, grid_lat, grid_lon,
                                 lon_scale=lon_scale)
    want = jax_rect.rasterize_circles(lats, lons, 0.3, grid_lat, grid_lon,
                                      lon_scale=lon_scale)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.any()


def test_constants_and_exports_equal_reference():
    assert queries.RADIUS_DEG == jax_queries.RADIUS_DEG
    assert segments.RADIUS_DEG is queries.RADIUS_DEG
    assert queries.RADIUS_DEG == 8 * 1852.0 / 111_111.0
    assert queries.DEFAULT_AGL_CEILING_FT == jax_queries.DEFAULT_AGL_CEILING_FT
    assert queries.HARD_MSL_CEILING_FT == jax_queries.HARD_MSL_CEILING_FT
    assert geometry.__all__ == jax_geometry.__all__
