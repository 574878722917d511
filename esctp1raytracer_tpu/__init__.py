"""esctp1raytracer_tpu — a differentiable Whitted ray tracer in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
CPU ray tracer (pg42819/EscTp1RayTracer): OBJ/MTL scene loading, pinhole
camera, Möller–Trumbore triangle intersection, Phong/Blinn shading with
sampled area lights and shadow rays, and P3 PPM output — re-designed for
array hardware:

* the scene is a flat, padded SoA primitive table (the analogue of the
  reference's ISPC flattening, reference src/simplify/flatten_iscp.cpp:35-111),
* closest-hit is a blockwise masked min-reduction over the primitive table
  (the reference's ISPC `foreach` over triangles, src/ispc/trace.ispc:70-84),
  in XLA or in one GPU kernel that keeps the running minimum in registers,
* the renderer is end-to-end differentiable w.r.t. geometry and materials
  with an O(rays) backward pass (gather-and-recompute at the winning hit),
* rendering scales over a `jax.sharding.Mesh` by sharding the ray grid
  (the reference's one-thread-per-row strategy, src/main.cpp:628-643,
  done the SPMD way).

Execution strategy matrix (reference CLI flags -> framework modes):
  sequential       -> backend "jnp"  (single-device jitted render)
  --thread         -> mode "sharded" (ray tiles over the device mesh)
  --ispc           -> backend "auto" (the sweep kernel on a GPU)
  --bvh            -> backend "mxu"  (feature-contraction brute force; the
                        reference BVH is slower than its own brute force,
                        see SURVEY.md quirk 3)
"""

from esctp1raytracer_tpu.scene.types import (
    Scene,
    TriangleBuffer,
    SphereBuffer,
    LightTable,
    Material,
)
from esctp1raytracer_tpu.scene.objloader import load_obj
from esctp1raytracer_tpu.scene.builders import (
    scene_from_mesh,
    cornell_box,
    cornell_variant,
    water_surface_mesh,
    write_obj,
    sphere_plane_scene,
    ten_sphere_scene,
    mixed_scene,
    random_scene,
)
from esctp1raytracer_tpu.core.camera import Camera
from esctp1raytracer_tpu.core.render import render, RenderConfig
from esctp1raytracer_tpu.io.ppm import write_ppm, read_ppm

__version__ = "0.2.0"

__all__ = [
    "Scene",
    "TriangleBuffer",
    "SphereBuffer",
    "LightTable",
    "Material",
    "load_obj",
    "scene_from_mesh",
    "cornell_box",
    "cornell_variant",
    "water_surface_mesh",
    "write_obj",
    "sphere_plane_scene",
    "ten_sphere_scene",
    "mixed_scene",
    "random_scene",
    "Camera",
    "render",
    "RenderConfig",
    "write_ppm",
    "read_ppm",
]
