"""Scenes and rays shared by the sweep-kernel tests (interpret mode).

The kernel is held to the plain reference `argmin_hit(use_mxu=False)`:
winners agree on at least 99.5% of rays (the quirk-16 eps band), and t
agrees to 2e-6 relative once scaled by |cos| of the incidence angle,
because a float32 plane hit's t is ill-conditioned at grazing incidence
(an ulp of the ray moves it by ~ulp / |cos|).
"""

import dataclasses
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from esctp1raytracer_tpu import Camera
from esctp1raytracer_tpu.core.intersect import EPS, argmin_hit
from esctp1raytracer_tpu.kernels.sweep_gpu import SweepSearch
from esctp1raytracer_tpu.scene import builders
from esctp1raytracer_tpu.scene.types import MeshData, Material, TriangleBuffer

WINNER_SHARE = 0.995
T_RTOL = 2e-6


def _tie_scene():
    """The same quad twice: every hit is an exact tie between two
    triangles, which the lower index must win."""
    quad = ((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2))
    q = builders._quad_mesh("floor", quad, Material.make(kd=(0.5, 0.5, 0.5)))
    twin = MeshData(name="twin", vertices=q.vertices.copy(), normals=None,
                    uv=None, material=q.material)
    light = builders._area_light(center=(0.0, 4.0, 0.0))
    return builders.scene_from_mesh([q, twin, light])


def _empty_scene():
    """A table of padding only: every ray misses."""
    return dataclasses.replace(builders.cornell_box(),
                               triangles=TriangleBuffer.empty(512))


_BUILD = {
    "cornell": (builders.cornell_box, (0, 1, 2), (0, 1, 0)),
    "mesh4": (lambda: builders.mesh_scene(4), (0, 2, 6), (0, 1, 0)),
    "mixed": (builders.mixed_scene, (0, 2.5, 7), (0, 1, 0)),
    "random": (lambda: builders.random_scene(2000, extent=4.0), (0, 4, 12),
               (0, 1, 0)),
    "empty": (_empty_scene, (0, 1, 2), (0, 1, 0)),
    "tie": (_tie_scene, (0.3, 3, 3), (0, 0, 0)),
}
SCENES = tuple(_BUILD)


@lru_cache(maxsize=None)
def scene(name):
    return _BUILD[name][0]()


@lru_cache(maxsize=None)
def rays(name, w=16, h=12):
    _, eye, look = _BUILD[name]
    cam = Camera.look_at(eye, look, vfov=60.0, aspect=w / h)
    o, d = cam.ray_grid(w, h)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def search(culled):
    return SweepSearch(culled=culled, interpret=True)


@lru_cache(maxsize=None)
def reference(name, w=16, h=12):
    o, d = rays(name, w, h)
    t, p, s = argmin_hit(o, d, scene(name), EPS, use_mxu=False)
    return np.asarray(t), np.asarray(p), np.asarray(s)


def check_closest(name, t, p, w=16, h=12):
    """Kernel (t, prim) against the reference on the same rays."""
    t_ref, p_ref, _ = reference(name, w, h)
    t, p = np.asarray(t), np.asarray(p)
    agree = p == p_ref
    assert agree.mean() >= WINNER_SHARE, agree.mean()
    both = agree & (p_ref >= 0)
    if not both.any():
        return
    o, d = rays(name, w, h)
    sc = scene(name)
    tri = sc.triangles
    nrm = np.cross(np.asarray(tri.v1 - tri.v0), np.asarray(tri.v2 - tri.v0))
    nrm = nrm[np.maximum(p_ref, 0)]
    cos = np.abs(np.sum(nrm * np.asarray(d), -1)) / np.maximum(
        np.linalg.norm(nrm, axis=-1), 1e-30)
    # Sphere winners carry their own (analytic) t in both searches.
    cos = np.where(reference(name, w, h)[2], 1.0, cos)
    rel = np.abs(t[both] - t_ref[both]) / np.abs(t_ref[both])
    assert (rel * cos[both]).max() <= T_RTOL


def shadow_limits(name):
    """Per-ray ceilings around each reference hit: well short of it,
    just past it, and none (negative)."""
    t_ref, p_ref, _ = reference(name)
    i = np.arange(t_ref.shape[0])
    tl = np.where(i % 3 == 0, 0.5 * t_ref,
                  np.where(i % 3 == 1, t_ref * 1.01 + 1e-3, -1.0))
    tl = np.where(p_ref >= 0, tl, np.where(i % 2 == 0, 50.0, -1.0))
    return jnp.asarray(tl, jnp.float32)
