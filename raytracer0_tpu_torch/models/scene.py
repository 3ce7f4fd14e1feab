"""Scene representation: a dataclass of SoA tensors on one device
(port of raytracer0_tpu/models/scene.py).

A scene is data: editing positions, colors or lights changes tensors only.
The static structure fields (types, light slots, row lists) are Python
tuples, the same as in the JAX package, where they key the jit cache; here
the kernels and the integrator read them to dispatch.

All continuous fields (positions, joker params, colors, emission, IOR,
texture data) are the scene's parameters: the values a gradient-based fit
would move.  `Scene.from_arrays` carries the JAX package's parameters, as
numpy arrays, into the port.

Indexing convention: analytic meshes first, then SDF entries, so SDF
ordinal `i` is global mesh index `num_analytic + i`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch

from raytracer0_tpu_torch.models.materials import (
    MATERIALS, Material, MeshType, SdfShape, TexType,
)
from raytracer0_tpu_torch import rng as _rng
from raytracer0_tpu_torch.ops.sky import default_cubemap

#: Tensor fields in declaration order, with their dtypes.
TENSOR_FIELDS = {
    "pos": torch.float32,        # [N, 3] position / plane normal
    "joker": torch.float32,      # [N, 4] radius, plane w, box size, sdf params
    "aux": torch.float32,        # [N, 12] extra SDF params
    "mesh_type": torch.int32,    # [N] MeshType codes
    "sdf_shape": torch.int32,    # [N] SdfShape codes (-1 for non-SDF rows)
    "color": torch.float32,      # [N, 3]
    "emission": torch.float32,   # [N, 3] (glossiness for SPEC)
    "ior": torch.float32,        # [N] (negative = spectral Cauchy A)
    "tex_cmask": torch.float32,  # [N, 3]
    "tex_emask": torch.float32,  # [N, 3]
    "tex_params": torch.float32,  # [N, 4]
    "mat_type": torch.int32,     # [N]
    "tex_type": torch.int32,     # [N]
    "opts": torch.bool,          # [N, 4] color tex, emission tex, bump, cull
    "light_idx": torch.int32,    # [L] mesh index per light slot, -1 = none
    "images": torch.float32,     # [4, TH, TW, 4] image textures
    "noise": torch.float32,      # [256, 256, 4] noise LUT
    "cubemap": torch.float32,    # [6, CH, CW, 3] environment cubemap
}

#: Static structure fields (Python values), as in the JAX Scene.
STATIC_FIELDS = (
    "num_analytic", "num_sdfs", "use_sphere", "use_plane", "use_box",
    "tex_types_used", "sdf_shapes_static", "sphere_rows", "plane_rows",
    "box_rows", "mesh_types_static", "mat_types_static", "lights_static",
    "tex_types_static", "opts_static", "cubemap_is_procedural",
)


@dataclasses.dataclass(frozen=True)
class Scene:
    # --- geometry ---
    pos: torch.Tensor
    joker: torch.Tensor
    aux: torch.Tensor
    mesh_type: torch.Tensor
    sdf_shape: torch.Tensor
    # --- materials ---
    color: torch.Tensor
    emission: torch.Tensor
    ior: torch.Tensor
    tex_cmask: torch.Tensor
    tex_emask: torch.Tensor
    tex_params: torch.Tensor
    mat_type: torch.Tensor
    tex_type: torch.Tensor
    opts: torch.Tensor
    # --- lights ---
    light_idx: torch.Tensor
    # --- texture assets ---
    images: torch.Tensor
    noise: torch.Tensor
    cubemap: torch.Tensor
    # --- static structure ---
    num_analytic: int = 0
    num_sdfs: int = 0
    use_sphere: bool = False
    use_plane: bool = False
    use_box: bool = False
    tex_types_used: tuple = ()
    sdf_shapes_static: tuple = ()
    sphere_rows: tuple = ()
    plane_rows: tuple = ()
    box_rows: tuple = ()
    mesh_types_static: tuple = ()
    mat_types_static: tuple = ()
    lights_static: tuple = ()
    tex_types_static: tuple = ()
    opts_static: tuple = ()
    cubemap_is_procedural: bool = False

    @property
    def num_meshes(self) -> int:
        return self.num_analytic + self.num_sdfs

    @property
    def num_lights(self) -> int:
        return int(self.light_idx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def replace(self, **kw) -> "Scene":
        """A copy with the given fields replaced (the JAX Scene's
        `replace`); tensors keep their autograd history."""
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, np.ndarray], static: Mapping,
                    device) -> "Scene":
        """Build a Scene from numpy arrays and static fields — the JAX
        Scene's parameters carried across (`np.asarray` of each leaf and
        the static attributes by name)."""
        tensors = {k: torch.as_tensor(np.array(arrays[k]), dtype=dt,
                                      device=device)
                   for k, dt in TENSOR_FIELDS.items()}
        statics = {k: static[k] for k in STATIC_FIELDS}
        return cls(**tensors, **statics)


def _as_mat(mat: Union[str, Material]) -> tuple[str, Material]:
    if isinstance(mat, str):
        return mat, MATERIALS[mat]
    return "", mat


class SceneBuilder:
    """Programmatic scene construction (`models.dsl` parses the reference's
    text format into this builder)."""

    def __init__(self):
        self._rows = []          # analytic rows
        self._sdf_rows = []      # SDF rows (always packed after analytic)
        self._images = None
        self._cubemap = None
        self._explicit_lights: Optional[Sequence[int]] = None

    def add(self, mat: Union[str, Material], mesh_type: MeshType,
            pos: Sequence[float], joker: Sequence[float],
            sdf_shape: SdfShape = SdfShape.BOX,
            aux: Optional[Sequence[float]] = None):
        """Add one mesh row (one DSL line: `MAT, TYPE, vec3(pos), vec4(joker)`).
        `aux` carries up to 12 extra SDF floats (triangle/quad vertices)."""
        name, m = _as_mat(mat)
        joker = tuple(joker) + (0.0,) * (4 - len(joker))
        aux = tuple(aux) if aux is not None else ()
        aux = aux + (0.0,) * (12 - len(aux))
        row = dict(name=name, mat=m, mesh_type=MeshType(mesh_type),
                   pos=tuple(pos), joker=joker[:4], sdf_shape=SdfShape(sdf_shape),
                   aux=aux[:12])
        if row["mesh_type"] in (MeshType.SDF, MeshType.GRID_SDF):
            self._sdf_rows.append(row)
        else:
            self._rows.append(row)
        return self

    def images(self, images):
        """Assign the 4 image textures: f32[4, TH, TW, 4] in [0, 1]."""
        self._images = np.asarray(images, np.float32)
        return self

    def cubemap(self, faces):
        """Assign a 6-face environment map: f32[6, CH, CW, 3]."""
        self._cubemap = np.asarray(faces, np.float32)
        return self

    def lights(self, indices: Sequence[int]):
        """Override automatic light detection with explicit mesh indices."""
        self._explicit_lights = list(indices)
        return self

    def build(self, device="cuda") -> Scene:
        rows = self._rows + self._sdf_rows
        n = len(rows)
        if n == 0:
            raise ValueError("scene has no meshes")

        pos = np.zeros((n, 3), np.float32)
        joker = np.zeros((n, 4), np.float32)
        aux = np.zeros((n, 12), np.float32)
        mesh_type = np.zeros((n,), np.int32)
        sdf_shape = np.full((n,), -1, np.int32)
        color = np.zeros((n, 3), np.float32)
        emission = np.zeros((n, 3), np.float32)
        ior = np.zeros((n,), np.float32)
        mat_type = np.zeros((n,), np.int32)
        tex_type = np.full((n,), int(TexType.NONE), np.int32)
        tex_cmask = np.ones((n, 3), np.float32)
        tex_emask = np.ones((n, 3), np.float32)
        tex_params = np.zeros((n, 4), np.float32)
        opts = np.zeros((n, 4), bool)

        lights = []
        for i, row in enumerate(rows):
            m = row["mat"]
            pos[i] = row["pos"]
            joker[i] = row["joker"]
            aux[i] = row["aux"]
            mesh_type[i] = int(row["mesh_type"])
            if row["mesh_type"] in (MeshType.SDF, MeshType.GRID_SDF):
                sdf_shape[i] = int(row["sdf_shape"])
            color[i] = m.c
            emission[i] = m.e
            ior[i] = m.nt
            mat_type[i] = int(m.t)
            tex_type[i] = int(m.tex.t)
            tex_cmask[i] = m.tex.c_mask
            tex_emask[i] = m.tex.e_mask
            tex_params[i] = m.tex.params
            opts[i] = m.opts
            # Light auto-detection matches the reference DSL: any material
            # whose *name* contains "MAT_LIGHT".
            if "MAT_LIGHT" in row["name"]:
                lights.append(i)

        if self._explicit_lights is not None:
            lights = list(self._explicit_lights)
        if not lights:
            lights = [-1]  # sentinel row, as in the reference

        num_analytic = len(self._rows)
        types_present = {int(r["mesh_type"]) for r in self._rows}

        images = (self._images if self._images is not None
                  else np.ones((4, 1, 1, 4), np.float32))
        if self._cubemap is not None:
            cubemap, cubemap_procedural = self._cubemap, False
        else:
            # procedural fallback so use_cubemap scenes never see black
            cubemap, cubemap_procedural = default_cubemap(64), True

        arrays = dict(
            pos=pos, joker=joker, aux=aux, mesh_type=mesh_type,
            sdf_shape=sdf_shape, color=color, emission=emission, ior=ior,
            tex_cmask=tex_cmask, tex_emask=tex_emask, tex_params=tex_params,
            mat_type=mat_type, tex_type=tex_type, opts=opts,
            light_idx=np.asarray(lights, np.int32), images=images,
            noise=_rng.noise_lut().numpy(), cubemap=cubemap,
        )
        static = dict(
            num_analytic=num_analytic, num_sdfs=len(self._sdf_rows),
            use_sphere=int(MeshType.SPHERE) in types_present,
            use_plane=int(MeshType.PLANE) in types_present,
            use_box=int(MeshType.BOX) in types_present,
            tex_types_used=tuple(sorted({int(t) for t in tex_type
                                         if t != int(TexType.NONE)})),
            sdf_shapes_static=tuple(int(r["sdf_shape"]) for r in self._sdf_rows),
            sphere_rows=tuple(int(i) for i in np.nonzero(
                mesh_type == int(MeshType.SPHERE))[0]),
            plane_rows=tuple(int(i) for i in np.nonzero(
                mesh_type == int(MeshType.PLANE))[0]),
            box_rows=tuple(int(i) for i in np.nonzero(
                mesh_type == int(MeshType.BOX))[0]),
            mesh_types_static=tuple(int(t) for t in mesh_type),
            mat_types_static=tuple(int(t) for t in mat_type),
            lights_static=tuple(int(i) for i in lights),
            tex_types_static=tuple(int(t) for t in tex_type),
            opts_static=tuple((bool(o[0]), bool(o[1])) for o in opts),
            cubemap_is_procedural=cubemap_procedural,
        )
        return Scene.from_arrays(arrays, static, device)


def animate_positions(scene: Scene, time_s, render_mode: int) -> Scene:
    """Per-frame animated mesh positions (raytracer.glsl:263-298, the JAX
    package's `animate_positions`): the identity for STATIC renders.

    Two branches, as the reference's `getAnimatedPosition`:

    * rows 6..14 orbit on circles whose speed and phase derive from the row
      index (269-277), analytic and SDF rows alike;
    * SDF rows (281-295) then rotate their position about the world Y axis
      at 0.5 rad/s and bob by sin(1.5 t) * 0.05.

    Torch ops on `scene.pos`, so autograd carries the positions (and a
    `time_s` tensor) through it.  Time is a float32 scalar, as in the JAX
    package's jitted pass, so `t * 1.5` rounds in float32.
    """
    if int(render_mode) == 0:
        return scene
    pos = scene.pos
    n = pos.shape[0]
    t = torch.as_tensor(time_s, dtype=torch.float32, device=pos.device)
    idx = torch.arange(n, dtype=torch.float32, device=pos.device)
    animated = ((idx >= 6) & (idx <= 14)).to(torch.float32)
    speed = 1.0 + (idx - 6.0) * 0.2
    phase = (idx - 6.0) * 0.7
    radius = 0.6
    dx = torch.cos(t * speed + phase) * radius * 0.3
    dz = torch.sin(t * speed + phase) * radius * 0.3
    dy = torch.sin(t * speed * 2.0 + phase) * 0.1
    pos = pos + torch.stack([dx, dy, dz], dim=-1) * animated[:, None]

    if scene.num_sdfs > 0:
        angle = t * 0.5
        ca, sa = torch.cos(angle), torch.sin(angle)
        rx = pos[:, 0] * ca - pos[:, 2] * sa
        rz = pos[:, 0] * sa + pos[:, 2] * ca
        ry = pos[:, 1] + torch.sin(t * 1.5) * 0.05
        is_sdf = torch.arange(n, device=pos.device) >= scene.num_analytic
        pos = torch.where(is_sdf[:, None], torch.stack([rx, ry, rz], dim=-1), pos)
    return scene.replace(pos=pos)
