"""Closest-hit sweep kernel (kernels/sweep_gpu.py) in interpret mode
against the plain reference, brute and culled entries."""

import numpy as np
import pytest

from esctp1raytracer_tpu.core.intersect import EPS, argmin_hit

from sweep_cases import SCENES, check_closest, rays, reference, scene, search


@pytest.mark.parametrize("culled", [False, True], ids=["brute", "culled"])
@pytest.mark.parametrize("name", SCENES)
def test_closest_matches_reference(name, culled):
    o, d = rays(name)
    t, p = search(culled)(o, d, scene(name).triangles, EPS)
    assert t.shape == p.shape == (o.shape[0],)
    if name == "mixed":
        # Triangle search only: hold argmin_hit's sphere merge to the
        # reference as well.
        t, p, s = argmin_hit(o, d, scene(name), EPS,
                             tri_search=search(culled))
        np.testing.assert_array_equal(np.asarray(s), reference(name)[2])
    check_closest(name, t, p)


@pytest.mark.parametrize("culled", [False, True], ids=["brute", "culled"])
def test_tie_goes_to_lowest_index(culled):
    """Two identical triangles: first-wins, as `t2 >= t -> reject`."""
    o, d = rays("tie")
    _, p = search(culled)(o, d, scene("tie").triangles, EPS)
    p = np.asarray(p)
    hits = p >= 0
    assert hits.any()
    # Triangles 0-1 are the quad, 2-3 its twin: the twin never wins.
    assert (p[hits] < 2).all()


@pytest.mark.parametrize("culled", [False, True], ids=["brute", "culled"])
def test_empty_table_misses_everything(culled):
    o, d = rays("empty")
    t, p = search(culled)(o, d, scene("empty").triangles, EPS)
    assert (np.asarray(p) == -1).all()
    assert (np.asarray(t) >= 1e29).all()
