"""Exactness of the sphere t-ceiling hint.

argmin_hit hands the best sphere hit to a triangle search as a per-ray
t-ceiling (core/intersect.py): it bounds the triangle winner, so the
culled sweep may only drop tiles whose slab entry lies beyond a known
real hit, and search results must be bit-identical with or without it.
"""

import numpy as np
import pytest

from esctp1raytracer_tpu import Camera
from esctp1raytracer_tpu.core.intersect import argmin_hit
from esctp1raytracer_tpu.kernels.sweep_gpu import SweepSearch
from esctp1raytracer_tpu.scene.builders import mixed_scene

CULLED = SweepSearch(culled=True, interpret=True)


def _rays(scene_eye, look, n=40):
    cam = Camera.look_at(scene_eye, look, vfov=60.0, aspect=1.0)
    o, d = cam.ray_grid(n, n)
    return o.reshape(-1, 3), d.reshape(-1, 3)


@pytest.fixture(scope="module")
def mixed():
    return mixed_scene()  # triangles + analytic spheres


class TestSpherePrehit:
    def test_argmin_identical_with_sphere_ceiling(self, mixed):
        o, d = _rays((0, 2, 8), (0, 1, 0))

        def no_ceiling(o, d, tris, eps, t_limit=None):
            return CULLED(o, d, tris, eps)

        t0, p0, s0 = argmin_hit(o, d, mixed, tri_search=no_ceiling)
        t1, p1, s1 = argmin_hit(o, d, mixed, tri_search=CULLED)
        np.testing.assert_array_equal(np.asarray(p0), np.asarray(p1))
        np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
        np.testing.assert_array_equal(np.asarray(s0), np.asarray(s1))

    def test_spheres_do_occlude_rays(self, mixed):
        # Sanity: the fixture actually has sphere winners, so the ceiling
        # test above is not vacuous.
        o, d = _rays((0, 2, 8), (0, 1, 0))
        _, _, is_sphere = argmin_hit(o, d, mixed, tri_search=CULLED)
        assert np.asarray(is_sphere).sum() > 10
