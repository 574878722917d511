"""Any-hit sweep kernel (kernels/sweep_gpu.py) in interpret mode against
the reference's closest-hit-under-ceiling, brute and culled entries."""

import jax.numpy as jnp
import numpy as np
import pytest

from esctp1raytracer_tpu.core.intersect import EPS, _scan_blocks, any_hit

from sweep_cases import (SCENES, WINNER_SHARE, rays, reference, scene, search,
                         shadow_limits)


@pytest.mark.parametrize("culled", [False, True], ids=["brute", "culled"])
@pytest.mark.parametrize("name", SCENES)
def test_occlusion_matches_reference(name, culled):
    o, d = rays(name)
    tl = shadow_limits(name)
    tris = scene(name).triangles
    occ = np.asarray(search(culled).occlusion(o, d, tl, tris, EPS))
    # Spheres are not in the triangle table: compare triangle occlusion.
    t_tri, _ = _scan_blocks(o, d, tris, EPS, 512, False)
    ref = np.asarray(t_tri < tl)
    assert occ.shape == (o.shape[0],)
    assert (occ == ref).mean() >= WINNER_SHARE
    assert not occ[np.asarray(tl) <= 0].any()


@pytest.mark.parametrize("culled", [False, True], ids=["brute", "culled"])
def test_any_hit_through_intersect(culled):
    """core.intersect.any_hit uses the kernel's `occlusion` method and
    ORs in the spheres."""
    o, d = rays("mixed")
    tl = shadow_limits("mixed")
    got = any_hit(o, d, tl, scene("mixed"), EPS, tri_search=search(culled))
    want = any_hit(o, d, tl, scene("mixed"), EPS, use_mxu=False)
    assert (np.asarray(got) == np.asarray(want)).mean() >= WINNER_SHARE


@pytest.mark.parametrize("culled", [False, True], ids=["brute", "culled"])
def test_every_ray_occluded_exits_early_and_right(culled):
    """Ceilings far past every hit: all hitting rays are occluded, and
    the early exit must not drop any."""
    o, d = rays("cornell")
    t_ref, p_ref, _ = reference("cornell")
    tl = jnp.where(jnp.asarray(p_ref) >= 0, 100.0, -1.0)
    occ = np.asarray(search(culled).occlusion(
        o, d, tl, scene("cornell").triangles, EPS))
    np.testing.assert_array_equal(occ, p_ref >= 0)
