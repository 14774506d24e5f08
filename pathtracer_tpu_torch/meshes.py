"""Procedural test meshes and OBJ export, the PyTorch counterpart of
``pathtracer_tpu/meshes.py``.

The large-scene workloads: ``sphere_in_box(50, 100)`` (9,812 triangles) and
``mesh_garden()`` (105,708 triangles).  ``save_obj`` writes a builder out,
so the OBJ loader round-trips real files.
"""

from __future__ import annotations

import math
from typing import Optional

from .camera import make_camera
from .linalg import DEG2RAD
from .scene import Diffuse, Emit, HostMaterial, SceneBuilder


def uv_sphere(center, radius, n_lat: int, n_lon: int,
              material: Optional[HostMaterial] = None,
              builder: Optional[SceneBuilder] = None) -> SceneBuilder:
    """Latitude/longitude sphere: 2 * n_lat * n_lon - 2 * n_lon triangles."""
    if material is None:
        material = Diffuse(0.8)
    sb = builder if builder is not None else SceneBuilder()
    cx, cy, cz = center

    def vert(i, j):
        th = math.pi * i / n_lat
        ph = 2 * math.pi * j / n_lon
        return (cx + radius * math.sin(th) * math.cos(ph),
                cy + radius * math.cos(th),
                cz + radius * math.sin(th) * math.sin(ph))

    for i in range(n_lat):
        for j in range(n_lon):
            a = vert(i, j)
            b = vert(i + 1, j)
            c = vert(i + 1, (j + 1) % n_lon)
            d = vert(i, (j + 1) % n_lon)
            if i < n_lat - 1:
                sb.add_triangle(a, b, c, material)
            if i > 0:
                sb.add_triangle(a, c, d, material)
    return sb


def torus(center, R, r, n_major: int, n_minor: int,
          material: Optional[HostMaterial] = None,
          builder: Optional[SceneBuilder] = None) -> SceneBuilder:
    if material is None:
        material = Diffuse(0.8)
    sb = builder if builder is not None else SceneBuilder()
    cx, cy, cz = center

    def vert(i, j):
        u = 2 * math.pi * i / n_major
        v = 2 * math.pi * j / n_minor
        return (cx + (R + r * math.cos(v)) * math.cos(u),
                cy + r * math.sin(v),
                cz + (R + r * math.cos(v)) * math.sin(u))

    for i in range(n_major):
        for j in range(n_minor):
            a = vert(i, j)
            b = vert(i + 1, j)
            c = vert(i + 1, j + 1)
            d = vert(i, j + 1)
            sb.add_triangle(a, b, c, material)
            sb.add_triangle(a, c, d, material)
    return sb


def _room(sb: SceneBuilder, s: float = 500.0) -> None:
    """The lit 500^3 room: floor, ceiling, back wall, green and red side
    walls, and a light panel just below the ceiling."""
    white, light = Diffuse(1), Emit(1)
    sb.add_quad(((s, 0, 0), (0, 0, 0), (0, 0, s), (s, 0, s)), white)
    sb.add_quad(((s, s, 0), (0, s, 0), (0, s, s), (s, s, s)), white)
    sb.add_quad(((s, 0, s), (0, 0, s), (0, s, s), (s, s, s)), white)
    sb.add_quad(((0, 0, s), (0, 0, 0), (0, s, 0), (0, s, s)),
                Diffuse(0, 1, 0))
    sb.add_quad(((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0)),
                Diffuse(1, 0, 0))
    sb.add_quad(((330, s - 1, 170), (330, s - 1, 330), (170, s - 1, 330),
                 (170, s - 1, 170)), light)


def sphere_in_box(n_lat: int = 50, n_lon: int = 100, device="cuda"):
    """A sphere of 2 * n_lat * n_lon - 2 * n_lon triangles in the lit room
    (9,812 triangles in all at the defaults).  Returns (camera on
    ``device``, builder)."""
    sb = SceneBuilder()
    _room(sb)
    uv_sphere((250, 180, 250), 140.0, n_lat, n_lon, Diffuse(0.75),
              builder=sb)
    cam = make_camera((250, 250, -420), (0, 0, 1), (0, 1, 0), (512, 512),
                      60 * DEG2RAD, 1.0, device=device)
    return cam, sb


def mesh_garden(grid: int = 7, n_lat: int = 22, n_lon: int = 48,
                device="cuda"):
    """A grid x grid field of alternating spheres and tori, each with its
    own diffuse color, in the lit room (105,708 triangles at the defaults).
    Returns (camera on ``device``, builder)."""
    sb = SceneBuilder()
    _room(sb)
    s = 500.0
    pitch = s / (grid + 1)
    r = 0.36 * pitch
    for i in range(grid):
        for j in range(grid):
            cx = pitch * (i + 1)
            cz = pitch * (j + 1)
            cy = 60.0 + 30.0 * ((i * 7 + j * 3) % 5)
            col = (0.25 + 0.7 * ((i * 5 + j) % grid) / max(grid - 1, 1),
                   0.25 + 0.7 * ((j * 5 + i) % grid) / max(grid - 1, 1),
                   0.6)
            m = Diffuse(*col)
            if (i + j) % 2 == 0:
                uv_sphere((cx, cy, cz), r, n_lat, n_lon, m, builder=sb)
            else:
                torus((cx, cy, cz), 0.72 * r, 0.3 * r,
                      n_lon, n_lat + 2, m, builder=sb)
    cam = make_camera((250, 330, -420), (0, -0.12, 1), (0, 1, 0),
                      (512, 512), 62 * DEG2RAD, 1.0, device=device)
    return cam, sb


def save_obj(builder: SceneBuilder, obj_path: str,
             mtl_path: Optional[str] = None) -> None:
    """Write the builder's triangles as OBJ, and an MTL with the
    reference's illum mapping (illum 1 diffuse, illum 2 emissive)."""
    from . import materials as mat

    mats = {}
    for m in builder._m:
        key = (m.type, m.color, m.emit, m.roughness)
        if key not in mats:
            mats[key] = f"m{len(mats)}"

    if mtl_path is None:
        mtl_path = obj_path.rsplit(".", 1)[0] + ".mtl"
    with open(mtl_path, "w") as f:
        for (mtype, color, emit, rough), name in mats.items():
            f.write(f"newmtl {name}\n")
            if mtype == mat.EMIT:
                f.write(f"Ka {emit[0]} {emit[1]} {emit[2]}\nillum 2\n\n")
            else:
                f.write(f"Kd {color[0]} {color[1]} {color[2]}\nillum 1\n\n")

    with open(obj_path, "w") as f:
        f.write(f"mtllib {mtl_path.split('/')[-1]}\n")
        idx = {}
        lines = []
        for (v1, v2, v3), m in zip(builder._v, builder._m):
            ids = []
            for v in (v1, v2, v3):
                key = tuple(float(x) for x in v)
                if key not in idx:
                    idx[key] = len(idx) + 1
                    lines.append(f"v {key[0]} {key[1]} {key[2]}")
                ids.append(idx[key])
            name = mats[(m.type, m.color, m.emit, m.roughness)]
            lines.append(f"usemtl {name}")
            lines.append(f"f {ids[0]} {ids[1]} {ids[2]}")
        f.write("\n".join(lines) + "\n")
