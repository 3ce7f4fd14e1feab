"""Scene DSL parser — the reference's textarea scene format
(port of raytracer0_tpu/models/dsl.py).

    MAT_NAME, TYPE, vec3(x, y, z), vec4(a[, b, c, d])

TYPE is SPHERE | PLANE | BOX | SDF (| GRID_SDF | TRIANGLE); a vec4 with one
argument splats GLSL-style; materials come from the named library; lights
are auto-detected by the "MAT_LIGHT" name substring.  SDF lines take their
shape from `sdf_shapes[i]`, defaulting to BOX.
"""

from __future__ import annotations

import re
from typing import Sequence

from raytracer0_tpu.models.materials import MeshType, SdfShape
from raytracer0_tpu_torch.models.scene import Scene, SceneBuilder

_VEC_RE = re.compile(r"vec([234])\s*\(([^)]*)\)")


def _parse_vec(token: str, n: int) -> tuple:
    m = _VEC_RE.search(token)
    if not m:
        raise ValueError(f"expected vec{n}(...), got {token!r}")
    vals = [float(v) for v in m.group(2).split(",") if v.strip()]
    if len(vals) == 1:
        vals = vals * n  # GLSL splat: vec4(1.0) == vec4(1,1,1,1)
    if len(vals) < n:
        vals = vals + [0.0] * (n - len(vals))
    return tuple(vals[:n])


def parse_scene(text: str, sdf_shapes: Sequence[SdfShape] = (),
                device="cpu", **builder_kw) -> Scene:
    """Parse DSL text into a Scene on `device`.  `sdf_shapes[i]` selects the
    shape of the i-th SDF line (reference dropdown semantics)."""
    sb = SceneBuilder()
    sdf_i = 0
    for lineno, line in enumerate(text.strip().splitlines()):
        line = line.strip()
        if not line or line.startswith("//") or line.startswith("#"):
            continue
        # Split on top-level commas: MAT, TYPE, vec3(...), vec4(...)
        parts = re.split(r",(?![^()]*\))", line)
        if len(parts) < 4:
            raise ValueError(f"line {lineno + 1}: expected 4 fields: {line!r}")
        mat = parts[0].strip()
        mtype = parts[1].strip().upper()
        if mtype not in MeshType.__members__:
            raise ValueError(f"line {lineno + 1}: there's no such thing as {mtype}")
        pos = _parse_vec(parts[2], 3)
        joker = _parse_vec(parts[3], 4)
        shape = SdfShape.BOX
        if mtype in ("SDF", "GRID_SDF"):
            if sdf_i < len(sdf_shapes):
                shape = SdfShape(sdf_shapes[sdf_i])
            sdf_i += 1
        sb.add(mat, MeshType[mtype], pos, joker, sdf_shape=shape)
    for k, v in builder_kw.items():
        getattr(sb, k)(v)
    return sb.build(device=device)
