"""Scene data model: flat, padded, fixed-shape SoA buffers (JAX pytrees).

This is the array-native analogue of the reference's two scene forms:

* the nested per-geometry form `tracer::scene{geometry[], light_sources[]}`
  (reference src/scene/scene.h:9-44) survives only transiently as
  `MeshData` during loading;
* the flat form the hot loops actually consume — `ispc_triangle[]` with
  per-triangle material + normals + flags and a compacted light-face table
  (reference src/simplify/flatten_iscp.cpp:35-111, src/ispc/ispc_helpers.h:16-56)
  — becomes the padded SoA `TriangleBuffer`/`LightTable` below, extended
  with a `SphereBuffer` of parametric spheres the reference lacks.

Design rules (XLA):
* every array has a static shape, padded up to a tile-friendly multiple;
* padded (invalid) primitives carry a `valid=False` mask and degenerate
  geometry so they can never win the closest-hit argmin — the role the
  reference's t=1e30 sentinel plays in `new_hit_info`
  (src/ispc/ispc_helpers.h:87-94);
* everything is a registered dataclass pytree so scenes flow through
  `jax.jit`, `jax.grad`, and shardings unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

DEFAULT_PAD_MULTIPLE = 512


def _register(cls, meta_fields=()):
    data_fields = [f.name for f in dataclasses.fields(cls) if f.name not in meta_fields]
    return jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=list(meta_fields)
    )


def pad_to(n: int, multiple: int = DEFAULT_PAD_MULTIPLE) -> int:
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class Material:
    """Phong material — same five coefficients as the reference.

    Reference: `Material{ka,kd,ks,ke,Ns,lightsource}` src/scene/scene.h:9-19;
    an object is a light source iff dot(ke,ke) > 0
    (src/scene/sceneloader.cpp:63-64).
    """

    ka: np.ndarray
    kd: np.ndarray
    ks: np.ndarray
    ke: np.ndarray
    ns: float

    @property
    def is_light(self) -> bool:
        return float(np.dot(self.ke, self.ke)) > 0.0

    @staticmethod
    def make(ka=(0, 0, 0), kd=(0, 0, 0), ks=(0, 0, 0), ke=(0, 0, 0), ns=1.0) -> "Material":
        return Material(
            ka=np.asarray(ka, np.float32),
            kd=np.asarray(kd, np.float32),
            ks=np.asarray(ks, np.float32),
            ke=np.asarray(ke, np.float32),
            ns=float(ns),
        )


@dataclass
class MeshData:
    """One loaded geometry (host-side, pre-flattening).

    Mirrors `tracer::scene::Geometry` (reference src/scene/scene.h:21-33):
    de-indexed corner arrays + per-object material. `vertices[F,3,3]` holds
    the three corners of each triangle; `normals` is None when the OBJ had
    no `vn` records (the reference checks `normals.empty()`,
    src/main.cpp:733).
    """

    name: str
    vertices: np.ndarray  # [F, 3, 3] float32
    normals: Optional[np.ndarray]  # [F, 3, 3] float32 or None
    uv: Optional[np.ndarray]  # [F, 3, 2] float32 or None
    material: Material

    @property
    def num_faces(self) -> int:
        return int(self.vertices.shape[0])


@_register
@dataclass
class TriangleBuffer:
    """Flat padded SoA triangle table (the `ispc_triangle[]` analogue).

    Per-triangle material is denormalized exactly as the reference's ISPC
    flattener does (src/simplify/flatten_iscp.cpp:60-96): full ka/kd/ks/ke/ns
    per triangle plus has_normals / is_light flags and geom/prim ids.
    """

    v0: jax.Array  # [N, 3]
    v1: jax.Array  # [N, 3]
    v2: jax.Array  # [N, 3]
    n0: jax.Array  # [N, 3]
    n1: jax.Array  # [N, 3]
    n2: jax.Array  # [N, 3]
    has_normals: jax.Array  # [N] bool
    uv0: jax.Array  # [N, 2] — texcoords carried through the flatten like
    uv1: jax.Array  # [N, 2]   the reference's Geometry.uv (scene.h:21-33);
    uv2: jax.Array  # [N, 2]   neither renderer samples textures (yet)
    has_uv: jax.Array  # [N] bool
    ka: jax.Array  # [N, 3]
    kd: jax.Array  # [N, 3]
    ks: jax.Array  # [N, 3]
    ke: jax.Array  # [N, 3]
    ns: jax.Array  # [N]
    is_light: jax.Array  # [N] bool
    geom_id: jax.Array  # [N] int32
    prim_id: jax.Array  # [N] int32
    valid: jax.Array  # [N] bool

    @property
    def capacity(self) -> int:
        return int(self.v0.shape[0])

    def take(self, idx: jax.Array) -> "TriangleBuffer":
        """Gather triangles by index (differentiable w.r.t. the buffers)."""
        return jax.tree.map(lambda a: jnp.take(a, idx, axis=0), self)

    @staticmethod
    def empty(capacity: int = DEFAULT_PAD_MULTIPLE) -> "TriangleBuffer":
        z3 = jnp.zeros((capacity, 3), jnp.float32)
        z2 = jnp.zeros((capacity, 2), jnp.float32)
        z1 = jnp.zeros((capacity,), jnp.float32)
        zb = jnp.zeros((capacity,), bool)
        zi = jnp.full((capacity,), -1, jnp.int32)
        return TriangleBuffer(
            v0=z3, v1=z3, v2=z3, n0=z3, n1=z3, n2=z3, has_normals=zb,
            uv0=z2, uv1=z2, uv2=z2, has_uv=zb,
            ka=z3, kd=z3, ks=z3, ke=z3, ns=z1, is_light=zb,
            geom_id=zi, prim_id=zi, valid=zb,
        )


@_register
@dataclass
class SphereBuffer:
    """Flat padded SoA sphere table — a primitive family the reference lacks
    (added per BASELINE.json configs; differentiable w.r.t. center/radius)."""

    center: jax.Array  # [S, 3]
    radius: jax.Array  # [S]
    ka: jax.Array  # [S, 3]
    kd: jax.Array  # [S, 3]
    ks: jax.Array  # [S, 3]
    ke: jax.Array  # [S, 3]
    ns: jax.Array  # [S]
    valid: jax.Array  # [S] bool

    @property
    def capacity(self) -> int:
        return int(self.center.shape[0])

    def take(self, idx: jax.Array) -> "SphereBuffer":
        return jax.tree.map(lambda a: jnp.take(a, idx, axis=0), self)

    @staticmethod
    def empty(capacity: int = 8) -> "SphereBuffer":
        z3 = jnp.zeros((capacity, 3), jnp.float32)
        z1 = jnp.zeros((capacity,), jnp.float32)
        zb = jnp.zeros((capacity,), bool)
        return SphereBuffer(center=z3, radius=z1, ka=z3, kd=z3, ks=z3, ke=z3,
                            ns=z1, valid=zb)


@_register
@dataclass
class LightTable:
    """Per-light-source table of emissive triangle indices.

    Mirrors `ispc_light{geom_id, light_faces*, num_light_faces}` plus the
    compacted light-triangle list (reference src/ispc/ispc_helpers.h:52-56,
    src/simplify/flatten_iscp.cpp:60-103): light source l owns
    `tri_idx[l, :face_count[l]]` indices into the global TriangleBuffer.
    Shading divides by the number of light *sources* (emissive geometries),
    not faces — exactly `float(SceneMesh.light_sources.size())`
    (src/main.cpp:769-770).
    """

    tri_idx: jax.Array  # [L, F] int32 — padded with repeats of face 0
    face_count: jax.Array  # [L] int32

    @property
    def num_lights(self) -> int:
        return int(self.tri_idx.shape[0])

    @property
    def max_faces(self) -> int:
        return int(self.tri_idx.shape[1])

    @staticmethod
    def empty() -> "LightTable":
        return LightTable(
            tri_idx=jnp.zeros((0, 1), jnp.int32),
            face_count=jnp.zeros((0,), jnp.int32),
        )


@_register
@dataclass
class Scene:
    """The complete flattened scene consumed by every renderer backend."""

    triangles: TriangleBuffer
    spheres: SphereBuffer
    lights: LightTable

    @property
    def num_triangles(self) -> int:
        return self.triangles.capacity

    @property
    def num_spheres(self) -> int:
        return self.spheres.capacity

    @property
    def num_lights(self) -> int:
        return self.lights.num_lights

    def device_put(self, sharding=None) -> "Scene":
        if sharding is None:
            return jax.device_put(self)
        return jax.device_put(self, sharding)
