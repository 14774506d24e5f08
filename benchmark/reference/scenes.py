"""The benchmark's scenes and cameras, made from the configuration files.

The benchmark makes the inputs itself and hands the same arrays to the
program (``Scene.from_arrays``, ``make_camera``) and to the plain
reference.  Geometry is written from the published scene descriptions:
the Cornell box of the upstream's ``examples/cornell_box.cc`` (quads
split into two triangles), and the procedural garden of spheres and tori
in a lit room.  Arrays are padded to a multiple of 8 rows with all-zero
triangles, which every test rejects.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

EMIT, DIFFUSE, SPECULAR = 1, 2, 3
PAD = 8


@dataclasses.dataclass
class SceneArrays:
    """Padded host arrays; rows past ``num_tris`` are padding."""
    v1: np.ndarray
    v2: np.ndarray
    v3: np.ndarray
    mat_type: np.ndarray
    albedo: np.ndarray
    emit: np.ndarray
    roughness: np.ndarray
    num_tris: int

    def as_args(self):
        return (self.v1, self.v2, self.v3, self.mat_type, self.albedo,
                self.emit, self.roughness, self.num_tris)


class _Builder:
    def __init__(self):
        self.tris, self.mats = [], []

    def tri(self, a, b, c, mat):
        self.tris.append((a, b, c))
        self.mats.append(mat)

    def quad(self, q, mat, fan=False):
        a, b, c, d = q
        self.tri(a, b, c, mat)
        if fan:
            self.tri(a, c, d, mat)
        else:
            self.tri(d, c, a, mat)

    def arrays(self) -> SceneArrays:
        n = len(self.tris)
        padded = -(-n // PAD) * PAD
        v = np.zeros((3, padded, 3), np.float32)
        v[:, :n] = np.asarray(self.tris, np.float64).transpose(1, 0, 2)
        mtype = np.zeros(padded, np.int32)
        albedo = np.zeros((padded, 3), np.float32)
        emit = np.zeros((padded, 3), np.float32)
        rough = np.zeros(padded, np.float32)
        for i, (t, col, em, r) in enumerate(self.mats):
            mtype[i], albedo[i], emit[i], rough[i] = t, col, em, r
        return SceneArrays(v[0], v[1], v[2], mtype, albedo, emit, rough, n)


def _diffuse(r, g=None, b=None):
    return (DIFFUSE, (r, r, r) if g is None else (r, g, b), (0, 0, 0), 0.0)


def _emit(e):
    return (EMIT, (0, 0, 0), (e, e, e), 0.0)


def cornell_box(cfg: dict) -> SceneArrays:
    """The Cornell box of the configuration: its quads in file order, the
    tall box's quads fanned."""
    sb = _Builder()
    mats = {"white": _diffuse(1), "light": _emit(1),
            "green": _diffuse(0, 1, 0), "red": _diffuse(1, 0, 0)}
    for q in cfg["quads"]:
        sb.quad(q["corners"], mats[q["material"]], fan=q.get("fan", False))
    return sb.arrays()


def _room(sb: _Builder, s: float) -> None:
    sb.quad(((s, 0, 0), (0, 0, 0), (0, 0, s), (s, 0, s)), _diffuse(1))
    sb.quad(((s, s, 0), (0, s, 0), (0, s, s), (s, s, s)), _diffuse(1))
    sb.quad(((s, 0, s), (0, 0, s), (0, s, s), (s, s, s)), _diffuse(1))
    sb.quad(((0, 0, s), (0, 0, 0), (0, s, 0), (0, s, s)), _diffuse(0, 1, 0))
    sb.quad(((s, 0, 0), (s, 0, s), (s, s, s), (s, s, 0)), _diffuse(1, 0, 0))
    sb.quad(((330, s - 1, 170), (330, s - 1, 330), (170, s - 1, 330),
             (170, s - 1, 170)), _emit(1))


def _sphere(sb, center, radius, n_lat, n_lon, mat):
    cx, cy, cz = center

    def vert(i, j):
        th = math.pi * i / n_lat
        ph = 2 * math.pi * j / n_lon
        return (cx + radius * math.sin(th) * math.cos(ph),
                cy + radius * math.cos(th),
                cz + radius * math.sin(th) * math.sin(ph))

    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vert(i, j), vert(i + 1, j)
            c, d = vert(i + 1, (j + 1) % n_lon), vert(i, (j + 1) % n_lon)
            if i < n_lat - 1:
                sb.tri(a, b, c, mat)
            if i > 0:
                sb.tri(a, c, d, mat)


def _torus(sb, center, big_r, r, n_major, n_minor, mat):
    cx, cy, cz = center

    def vert(i, j):
        u = 2 * math.pi * i / n_major
        v = 2 * math.pi * j / n_minor
        return (cx + (big_r + r * math.cos(v)) * math.cos(u),
                cy + r * math.sin(v),
                cz + (big_r + r * math.cos(v)) * math.sin(u))

    for i in range(n_major):
        for j in range(n_minor):
            a, b = vert(i, j), vert(i + 1, j)
            c, d = vert(i + 1, j + 1), vert(i, j + 1)
            sb.tri(a, b, c, mat)
            sb.tri(a, c, d, mat)


def garden(cfg: dict) -> SceneArrays:
    """A grid x grid field of alternating spheres and tori, each with its
    own diffuse colour, in the lit room."""
    grid, n_lat, n_lon = cfg["grid"], cfg["n_lat"], cfg["n_lon"]
    s = float(cfg["room"])
    sb = _Builder()
    _room(sb, s)
    pitch = s / (grid + 1)
    r = 0.36 * pitch
    for i in range(grid):
        for j in range(grid):
            center = (pitch * (i + 1), 60.0 + 30.0 * ((i * 7 + j * 3) % 5),
                      pitch * (j + 1))
            mat = _diffuse(
                0.25 + 0.7 * ((i * 5 + j) % grid) / max(grid - 1, 1),
                0.25 + 0.7 * ((j * 5 + i) % grid) / max(grid - 1, 1), 0.6)
            if (i + j) % 2 == 0:
                _sphere(sb, center, r, n_lat, n_lon, mat)
            else:
                _torus(sb, center, 0.72 * r, 0.3 * r, n_lon, n_lat + 2, mat)
    return sb.arrays()


SCENES = {"cornell_box": cornell_box, "garden": garden}


def make_scene(cfg: dict) -> SceneArrays:
    return SCENES[cfg["scene"]["kind"]](cfg["scene"])


@dataclasses.dataclass
class CameraArrays:
    """A pinhole camera as the renderer defines it: ray direction
    ``x * right + y * up + distance * forward`` through
    ``(w + offset + jitter) * cell - v_res / 2``."""
    pos: np.ndarray
    forward: np.ndarray
    up: np.ndarray
    right: np.ndarray
    v_res: np.ndarray
    cell: np.float32
    distance: np.float32
    width: int
    height: int
    offset: float = 0.5


def make_camera(cfg: dict, res=None) -> CameraArrays:
    """The configuration's camera at ``res`` (default its own), in
    float32 as the renderer builds it."""
    c = cfg["camera"]
    w, h = res if res is not None else (cfg["width"], cfg["height"])
    pos = np.asarray(c["pos"], np.float32)
    forward = np.asarray(c["forward"], np.float32)
    up = np.asarray(c["up"], np.float32)
    fwd = forward / np.linalg.norm(forward)
    upn = up / np.linalg.norm(up)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    distance = float(c.get("distance", 1.0))
    vx = 2.0 * distance * math.tan(math.radians(c["fov_deg"]) / 2.0)
    vy = vx * h / w
    return CameraArrays(pos, fwd.astype(np.float32), upn.astype(np.float32),
                        right.astype(np.float32),
                        np.array([vx, vy], np.float32), np.float32(vx / w),
                        np.float32(distance), int(w), int(h))


def camera_args(cfg: dict, res=None) -> dict:
    """The arguments of the program's ``make_camera`` for this camera."""
    c = cfg["camera"]
    w, h = res if res is not None else (cfg["width"], cfg["height"])
    return dict(pos=tuple(c["pos"]), forward=tuple(c["forward"]),
                up=tuple(c["up"]), res=(int(w), int(h)),
                fov=math.radians(c["fov_deg"]),
                distance=float(c.get("distance", 1.0)))
