"""The cull pre-pass of the sweep kernel's culled entry: the interval
(per-group) slab mask must keep every tile the exact per-ray mask keeps."""

import jax.numpy as jnp
import numpy as np
import pytest

from esctp1raytracer_tpu import Camera
from esctp1raytracer_tpu.kernels.cull import block_cull_mask, group_cull_mask
from esctp1raytracer_tpu.kernels.sweep_gpu import _sorted_tiles
from esctp1raytracer_tpu.scene import builders

@pytest.fixture(scope="module")
def mesh():
    return builders.mesh_scene(3)  # 1280+2+2 tris


@pytest.fixture(scope="module")
def rays():
    cam = Camera.look_at((0, 2, 6), (0, 1, 0), vfov=60.0, aspect=1.0)
    o, d = cam.ray_grid(32, 16)
    return o.reshape(-1, 3), d.reshape(-1, 3)


class TestGroupCullMask:
    def test_conservative_vs_per_ray(self, mesh, rays):
        """The interval mask must be a superset of the exact 8-ray OR."""
        o, d = rays
        _, aabbs, _ = _sorted_tiles(mesh.triangles)
        ns = aabbs.shape[1]
        exact = np.asarray(jnp.any(
            block_cull_mask(o, d, aabbs, None).reshape(-1, 8, ns), axis=1))
        hull = np.asarray(group_cull_mask(o, d, aabbs, None, group=8))
        assert not (exact & ~hull).any(), "interval mask dropped a block"

    def test_conservative_with_t_limit(self, mesh, rays):
        o, d = rays
        _, aabbs, _ = _sorted_tiles(mesh.triangles)
        ns = aabbs.shape[1]
        tl = jnp.where(jnp.arange(o.shape[0]) % 3 == 0, -1.0, 4.0
                       ).astype(jnp.float32)
        exact = np.asarray(jnp.any(
            block_cull_mask(o, d, aabbs, tl).reshape(-1, 8, ns), axis=1))
        hull = np.asarray(group_cull_mask(o, d, aabbs, tl, group=8))
        assert not (exact & ~hull).any()

    def test_incoherent_origins_stay_conservative(self, mesh):
        """Scattered origins (shadow-like wavefront): never drops blocks."""
        rng = np.random.default_rng(0)
        o = jnp.asarray(rng.uniform(-3, 3, (64, 3)).astype(np.float32))
        d = jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32))
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        _, aabbs, _ = _sorted_tiles(mesh.triangles)
        ns = aabbs.shape[1]
        exact = np.asarray(jnp.any(
            block_cull_mask(o, d, aabbs, None).reshape(-1, 8, ns), axis=1))
        hull = np.asarray(group_cull_mask(o, d, aabbs, None, group=8))
        assert not (exact & ~hull).any()


@pytest.mark.parametrize("with_limit", [False, True])
def test_conservative_at_kernel_group(mesh, rays, with_limit):
    """At the kernel's own group size (one program's rays)."""
    from esctp1raytracer_tpu.kernels.sweep_gpu import RAY_BLOCK

    o, d = rays
    _, aabbs, _ = _sorted_tiles(mesh.triangles)
    tl = jnp.full((o.shape[0],), 3.0) if with_limit else None
    ns = aabbs.shape[1]
    exact = np.asarray(jnp.any(
        block_cull_mask(o, d, aabbs, tl).reshape(-1, RAY_BLOCK, ns), axis=1))
    hull = np.asarray(group_cull_mask(o, d, aabbs, tl, group=RAY_BLOCK))
    assert not (exact & ~hull).any()
