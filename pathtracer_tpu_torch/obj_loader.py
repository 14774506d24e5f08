"""Wavefront OBJ/MTL scene import, the PyTorch counterpart of
``pathtracer_tpu/obj_loader.py``.

Material mapping, as in the reference renderer:
    illum 1 -> DIFFUSE with the material's diffuse color (Kd)
    illum 2 -> EMIT with the material's ambient color (Ka)
    other   -> a warning, then DIFFUSE(0.5)

Faces with more than 3 vertices are triangulated as a fan from the first
vertex; ``strict_reference_triangulation=True`` keeps only the first three
vertices, as the reference does.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

from . import materials as mat
from .scene import HostMaterial, Scene, SceneBuilder


class MtlMaterial:
    def __init__(self):
        self.ka = (0.0, 0.0, 0.0)
        self.kd = (0.8, 0.8, 0.8)
        self.illum = 1


def parse_mtl(path: str) -> Dict[str, MtlMaterial]:
    mats: Dict[str, MtlMaterial] = {}
    cur: Optional[MtlMaterial] = None
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "newmtl":
                cur = MtlMaterial()
                mats[tok[1]] = cur
            elif cur is None:
                continue
            elif tok[0] == "Ka":
                cur.ka = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "Kd":
                cur.kd = tuple(float(x) for x in tok[1:4])
            elif tok[0] == "illum":
                cur.illum = int(tok[1])
    return mats


def _to_host_material(m: Optional[MtlMaterial]) -> HostMaterial:
    if m is None:
        return HostMaterial(mat.DIFFUSE, color=(0.5, 0.5, 0.5))
    if m.illum == 1:
        return HostMaterial(mat.DIFFUSE, color=m.kd)
    if m.illum == 2:
        return HostMaterial(mat.EMIT, emit=m.ka)
    print(f"Unknown material type with illum: {m.illum}\n"
          f"Using default material: Diffuse(0.5)", file=sys.stderr)
    return HostMaterial(mat.DIFFUSE, color=(0.5, 0.5, 0.5))


def load_obj(filename: str, mtl_path: str = "./", *,
             default_material: Optional[HostMaterial] = None,
             strict_reference_triangulation: bool = False,
             builder: Optional[SceneBuilder] = None) -> SceneBuilder:
    """Parse an OBJ file into a SceneBuilder (returned, so callers can add
    geometry before ``.build()``)."""
    verts: List[Tuple[float, float, float]] = []
    mtls: Dict[str, MtlMaterial] = {}
    cur_mtl: Optional[MtlMaterial] = None
    sb = builder if builder is not None else SceneBuilder()
    if default_material is None:
        default_material = HostMaterial(mat.DIFFUSE, color=(0.5, 0.5, 0.5))

    with open(filename) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            if tok[0] == "v":
                verts.append(tuple(float(x) for x in tok[1:4]))
            elif tok[0] == "mtllib":
                for cand in (os.path.join(mtl_path, tok[1]),
                             os.path.join(os.path.dirname(filename), tok[1])):
                    if os.path.exists(cand):
                        mtls.update(parse_mtl(cand))
                        break
                else:
                    print(f"MTL file not found: {tok[1]}", file=sys.stderr)
            elif tok[0] == "usemtl":
                cur_mtl = mtls.get(tok[1])
                if cur_mtl is None:
                    print(f"Unknown material: {tok[1]}", file=sys.stderr)
            elif tok[0] == "f":
                # v, v/vt, v/vt/vn or v//vn; a negative index is relative
                ids = []
                for t in tok[1:]:
                    vi = int(t.split("/")[0])
                    ids.append(vi - 1 if vi > 0 else len(verts) + vi)
                hm = (_to_host_material(cur_mtl) if cur_mtl is not None
                      else default_material)
                if strict_reference_triangulation or len(ids) == 3:
                    sb.add_triangle(verts[ids[0]], verts[ids[1]],
                                    verts[ids[2]], hm)
                else:
                    for k in range(1, len(ids) - 1):
                        sb.add_triangle(verts[ids[0]], verts[ids[k]],
                                        verts[ids[k + 1]], hm)
    return sb


def load_obj_scene(filename: str, mtl_path: str = "./", *, device="cuda",
                   **kw) -> Scene:
    """The OBJ file's scene, on ``device``."""
    return load_obj(filename, mtl_path, **kw).build(device=device)
