"""The sweep kernel's wrapper: constant table, padding, ray counts, cull
lists — everything around the kernel that runs the same on any platform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from esctp1raytracer_tpu.core.intersect import EPS, mt_intersect
from esctp1raytracer_tpu.kernels import sweep_gpu
from esctp1raytracer_tpu.kernels.cull import group_cull_mask

from sweep_cases import check_closest, rays, scene, search


@pytest.mark.parametrize("culled", [False, True], ids=["brute", "culled"])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 130])
def test_ray_counts(n, culled):
    """Ray counts on and off the RAY_BLOCK multiple: shapes and answers."""
    o, d = rays("cornell")
    o, d = o[:n], d[:n]
    tris = scene("cornell").triangles
    t, p = search(culled)(o, d, tris, EPS)
    assert t.shape == p.shape == (n,)
    tl = jnp.full((n,), 10.0)
    occ = search(culled).occlusion(o, d, tl, tris, EPS)
    assert occ.shape == (n,) and occ.dtype == jnp.bool_
    full_t, full_p = search(culled)(*rays("cornell"), tris, EPS)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(full_p)[:n])
    np.testing.assert_array_equal(np.asarray(t), np.asarray(full_t)[:n])


@pytest.mark.parametrize("n", [1, 31, 32, 33, 512])
def test_tile_table_shape_and_padding(n):
    consts = jnp.arange(n * 12, dtype=jnp.float32).reshape(n, 12) + 1.0
    tc = np.asarray(sweep_gpu._tile_table(consts))
    nt = -(-n // sweep_gpu.TRI_TILE)
    assert tc.shape == (nt, 12, sweep_gpu.TRI_TILE)
    flat = tc.transpose(0, 2, 1).reshape(-1, 12)
    np.testing.assert_array_equal(flat[:n], np.asarray(consts))
    assert (flat[n:] == 0).all()  # zero normal: never hit


def test_ray_rows_padding():
    o = jnp.ones((70, 3))
    d = jnp.ones((70, 3)) * 2.0
    rows = np.asarray(sweep_gpu._ray_rows(o, d, jnp.full((70,), 3.0)))
    assert rows.shape == (8, 128)
    np.testing.assert_array_equal(rows[6, :70], 3.0)
    np.testing.assert_array_equal(rows[6, 70:], -1.0)  # never occluded
    np.testing.assert_array_equal(rows[3:6, 70:].T, [[0, 0, 1]] * 58)
    empty = sweep_gpu._ray_rows(jnp.zeros((0, 3)), jnp.zeros((0, 3)), None)
    assert empty.shape == (8, sweep_gpu.RAY_BLOCK)


def test_ray_rows_default_ceiling_is_open():
    rows = np.asarray(sweep_gpu._ray_rows(jnp.zeros((4, 3)),
                                          jnp.ones((4, 3)), None))
    assert (rows[6, :4] >= 1e29).all()


def test_constants_reproduce_mt():
    """The plane + barycentric constants give Moller-Trumbore's t, u, v."""
    rng = np.random.default_rng(0)
    tris = scene("random").triangles
    k = np.flatnonzero(np.asarray(tris.valid))[:64]
    c = np.asarray(sweep_gpu.tri_constants(tris))[k]
    o = rng.normal(size=(64, 3)).astype(np.float32) + np.array([0, 4, 12])
    target = np.asarray(tris.v0)[k] * 0.4 + np.asarray(tris.v1)[k] * 0.3 \
        + np.asarray(tris.v2)[k] * 0.3
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_mt, u_mt, v_mt, ok = mt_intersect(
        jnp.asarray(o), jnp.asarray(d), tris.v0[k], tris.v1[k], tris.v2[k])
    s = o - c[:, 3:6]
    det = -np.sum(d * c[:, 0:3], -1)
    t = np.sum(s * c[:, 0:3], -1) / det
    q = s + t[:, None] * d
    u = np.sum(c[:, 6:9] * q, -1)
    v = np.sum(c[:, 9:12] * q, -1)
    assert np.asarray(ok).all()
    # Half-unit triangles seen from ~12 units: barycentrics carry a few
    # 1e-4 of float32 rounding in either form.
    np.testing.assert_allclose(t, np.asarray(t_mt), rtol=1e-4)
    np.testing.assert_allclose(u, np.asarray(u_mt), atol=1e-3)
    np.testing.assert_allclose(v, np.asarray(v_mt), atol=1e-3)


def test_sorted_tiles_map_back_to_original():
    tris = scene("mesh4").triangles
    tc, aabbs, perm = sweep_gpu._sorted_tiles(tris)
    perm = np.asarray(perm)
    valid = np.asarray(tris.valid)
    kept = perm[perm >= 0]
    assert sorted(kept) == list(np.flatnonzero(valid))
    assert aabbs.shape == (8, tc.shape[0])
    # Every valid triangle lies inside its tile's box.
    v = np.stack([np.asarray(tris.v0), np.asarray(tris.v1),
                  np.asarray(tris.v2)], 1)
    tile = np.flatnonzero(perm >= 0) // sweep_gpu.TRI_TILE
    lo = v[kept].min(1)
    hi = v[kept].max(1)
    box = np.asarray(aabbs)
    assert (lo >= box[0:3, tile].T - 1e-6).all()
    assert (hi <= box[3:6, tile].T + 1e-6).all()


def test_cull_lists_ascending_and_counted():
    # A narrow bundle: 128 nearly parallel rays toward the icosphere.
    o = jnp.tile(jnp.asarray([[0.0, 2.0, 6.0]]), (128, 1))
    aim = jnp.stack([jnp.linspace(-0.2, 0.2, 128), jnp.full((128,), -1.0),
                     jnp.full((128,), -5.0)], axis=1)
    d = aim / jnp.linalg.norm(aim, axis=1, keepdims=True)
    tris = scene("mesh4").triangles
    tc, aabbs, _ = sweep_gpu._sorted_tiles(tris)
    rows = sweep_gpu._ray_rows(o, d, None)
    ids, cnt = sweep_gpu._cull_lists(rows, aabbs)
    ids, cnt = np.asarray(ids), np.asarray(cnt)
    keep = np.asarray(group_cull_mask(rows[0:3].T, rows[3:6].T, aabbs,
                                      rows[6], group=sweep_gpu.RAY_BLOCK))
    assert ids.shape == (rows.shape[1] // sweep_gpu.RAY_BLOCK, tc.shape[0])
    for g in range(len(cnt)):
        prefix = ids[g, :cnt[g]]
        np.testing.assert_array_equal(prefix, np.flatnonzero(keep[g]))
    assert 0 < cnt.max() < tc.shape[0] // 2  # a narrow bundle culls most


def test_culled_entry_under_jit():
    """The culled entry (Morton sort, pre-pass, kernel) traces inside an
    outer jit with the scene as an argument."""
    o, d = rays("mesh4")
    f = jax.jit(lambda tr, o, d: search(True)(o, d, tr, EPS))
    t, p = f(scene("mesh4").triangles, o, d)
    check_closest("mesh4", t, p)
