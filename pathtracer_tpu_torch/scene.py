"""Scene representation (L2), the PyTorch counterpart of
``pathtracer_tpu/scene.py``.

Structure of arrays: vertex tensors ``(T, 3)`` and per-triangle material
columns, padded to a multiple of 8 rows with degenerate all-zero triangles
that the |det| < EPS test rejects.  The fixtures reproduce the reference
example scenes' geometry data verbatim: ``cornell_box``,
``modified_cornell`` and the 3-triangle ``corner_scene``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from . import materials as mat
from .camera import Camera, make_camera
from .linalg import DEG2RAD
from .utils.profiling import trace_annotation

_TENSOR_FIELDS = ("v1", "v2", "v3", "mat_type", "albedo", "emit",
                  "roughness")
_CACHES = {"_host_v": _TENSOR_FIELDS[:3], "_host_m": _TENSOR_FIELDS[3:]}


@dataclasses.dataclass
class HostMaterial:
    """Host-side material description."""
    type: int
    color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    emit: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    roughness: float = 0.0


def Diffuse(r, g=None, b=None):
    if g is None:
        g = b = r
    return HostMaterial(mat.DIFFUSE, color=(r, g, b))


def Emit(r, g=None, b=None):
    if g is None:
        g = b = r
    return HostMaterial(mat.EMIT, emit=(r, g, b))


def Specular(roughness, r=1.0, g=None, b=None):
    if g is None:
        g = b = r
    return HostMaterial(mat.SPECULAR, color=(r, g, b), roughness=roughness)


@dataclasses.dataclass(frozen=True)
class Scene:
    """SoA scene on one device.  All tensors have ``padded_size`` rows.

    The host numpy arrays the scene was built from ride along (not
    dataclass fields), so kernel packers and checks read them without a
    device round trip; after an in-place edit of a tensor they are read
    again from the device (see ``_fresh``)."""
    v1: torch.Tensor         # (T, 3) float32
    v2: torch.Tensor         # (T, 3)
    v3: torch.Tensor         # (T, 3)
    mat_type: torch.Tensor   # (T,) int32; 0 = padding
    albedo: torch.Tensor     # (T, 3)
    emit: torch.Tensor       # (T, 3)
    roughness: torch.Tensor  # (T,)
    num_tris: int            # real (unpadded) triangle count
    has_specular: bool = True

    @classmethod
    def from_arrays(cls, v1, v2, v3, mat_type, albedo, emit, roughness,
                    num_tris: int, device="cuda") -> "Scene":
        """Scene from padded host arrays, with its host caches."""
        host_v = tuple(np.ascontiguousarray(a, np.float32)
                       for a in (v1, v2, v3))
        host_m = (np.ascontiguousarray(mat_type, np.int32),
                  np.ascontiguousarray(albedo, np.float32),
                  np.ascontiguousarray(emit, np.float32),
                  np.ascontiguousarray(roughness, np.float32))
        tensors = [torch.from_numpy(a.copy()).to(device)
                   for a in host_v + host_m]
        scene = cls(*tensors, num_tris=int(num_tris),
                    has_specular=bool(np.any(host_m[0] == mat.SPECULAR)))
        scene._set_cache("_host_v", host_v)
        scene._set_cache("_host_m", host_m)
        return scene

    @property
    def padded_size(self) -> int:
        return int(self.v1.shape[0])

    @property
    def device(self) -> torch.device:
        return self.v1.device

    # Host caches.  Each group of host copies is stored with the version
    # counters of the tensors it was read from; an in-place edit of a
    # tensor (``scene.v1[0] += 0.5``) bumps its counter, and the group is
    # then re-read from the device.  JAX arrays cannot be edited in place,
    # so the reference needs no such check.

    def _versions(self, cache: str) -> Tuple[Optional[int], ...]:
        # Inference tensors keep no version counter (None): a group
        # holding one is read from the device on every call.
        return tuple(None if t.is_inference() else t._version
                     for t in (getattr(self, f) for f in _CACHES[cache]))

    def _set_cache(self, cache: str, arrays) -> None:
        object.__setattr__(self, cache, arrays)
        object.__setattr__(self, cache + "_versions", self._versions(cache))

    def _fresh(self, cache: str):
        """The padded host arrays of ``cache``'s tensors: the cache while
        no tensor of the group has changed since it was made, else a
        (synchronising) copy from the device, which becomes the cache."""
        arrays = getattr(self, cache, None)
        live = self._versions(cache)
        if (arrays is None or None in live
                or getattr(self, cache + "_versions", None) != live):
            with trace_annotation("pt.scene.host_copy"):
                arrays = tuple(getattr(self, f).detach().to("cpu", copy=True)
                               .numpy() for f in _CACHES[cache])
            self._set_cache(cache, arrays)
        return arrays

    def to(self, device) -> "Scene":
        new = dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _TENSOR_FIELDS})
        for cache in _CACHES:
            # Carried only while it matches this scene's tensors; the moved
            # tensors' own counters are recorded beside it.
            if (hasattr(self, cache) and getattr(self, cache + "_versions")
                    == self._versions(cache)):
                new._set_cache(cache, getattr(self, cache))
        # The key's memo names its host tuples, so it holds on the new
        # scene only where both tuples came along.
        memo = getattr(self, "_fingerprint", None)
        if (memo is not None and memo[0] is getattr(new, "_host_v", None)
                and memo[1] is getattr(new, "_host_m", None)):
            object.__setattr__(new, "_fingerprint", memo)
        return new

    def host_verts(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """UNPADDED (n, 3) host vertex arrays, from the cache while the
        vertex tensors are unedited."""
        return tuple(a[:self.num_tris] for a in self._fresh("_host_v"))

    def host_materials(self):
        """UNPADDED host (mat_type, albedo, emit, roughness) arrays, from
        the cache while the material tensors are unedited."""
        return tuple(a[:self.num_tris] for a in self._fresh("_host_m"))

    def fingerprint(self) -> Tuple[int, str]:
        """Content key over the RAW BYTES of every geometry and material
        array: a float sum would let a sum-preserving edit pass for the
        same scene (a stale accel, a resumed run on another scene).

        Memoised per content version: the key is a pure function of the two
        host tuples ``_fresh`` returns, and ``_fresh`` returns the same
        tuple objects until a tensor is edited in place (and new ones on
        every call for inference tensors).  So a key kept beside the tuples
        it was hashed from, and reused only while both are those very
        objects, is the digest a fresh hash would give, byte for byte.  The
        span ``pt.scene.hash`` covers the hashing of the host bytes alone,
        that is one memo miss; a refresh of the host arrays is
        ``pt.scene.host_copy``."""
        hv, hm = self._fresh("_host_v"), self._fresh("_host_m")
        memo = getattr(self, "_fingerprint", None)
        if memo is not None and memo[0] is hv and memo[1] is hm:
            return memo[2]
        n = self.num_tris
        with trace_annotation("pt.scene.hash"):
            h = hashlib.sha1()
            for arr in hv + hm:
                a = np.ascontiguousarray(arr[:n])
                h.update(str(a.shape).encode())
                h.update(a.tobytes())
            key = (n, h.hexdigest())
        object.__setattr__(self, "_fingerprint", (hv, hm, key))
        return key

    def replace_materials(self, albedo=None, emit=None,
                          roughness=None) -> "Scene":
        """The scene with swapped material tensors (the differentiable
        path).  The geometry tensors are shared, so the host vertex cache
        stays, with their version counters; the host material cache does
        not, since it would describe the old materials to every packer and
        key that reads ``host_materials``."""
        new = dataclasses.replace(
            self,
            albedo=self.albedo if albedo is None else albedo,
            emit=self.emit if emit is None else emit,
            roughness=self.roughness if roughness is None else roughness)
        if hasattr(self, "_host_v"):
            object.__setattr__(new, "_host_v", self._host_v)
            object.__setattr__(new, "_host_v_versions",
                               self._host_v_versions)
        return new


class SceneBuilder:
    """Host-side accumulation of triangles."""

    def __init__(self):
        self._v = []
        self._m = []

    def add_triangle(self, v1, v2, v3,
                     material: HostMaterial) -> "SceneBuilder":
        self._v.append((v1, v2, v3))
        self._m.append(material)
        return self

    def add_quad(self, q, material: HostMaterial,
                 fan: bool = False) -> "SceneBuilder":
        """Two triangles for quad corners q = (a, b, c, d): (a,b,c),(d,c,a),
        or (a,b,c),(a,c,d) with ``fan=True`` (the tall box)."""
        a, b, c, d = q
        self.add_triangle(a, b, c, material)
        if fan:
            self.add_triangle(a, c, d, material)
        else:
            self.add_triangle(d, c, a, material)
        return self

    def __len__(self):
        return len(self._v)

    def build(self, pad_to_multiple: int = 8, device="cuda") -> Scene:
        """The scene on ``device``."""
        n = len(self._v)
        if n == 0:
            raise ValueError("No triangles in scene.")
        p = max(pad_to_multiple, 1)
        padded = ((n + p - 1) // p) * p

        verts = np.zeros((3, padded, 3), np.float32)
        for i, (a, b, c) in enumerate(self._v):
            verts[0, i] = a
            verts[1, i] = b
            verts[2, i] = c
        mtype = np.zeros((padded,), np.int32)
        albedo = np.zeros((padded, 3), np.float32)
        emit = np.zeros((padded, 3), np.float32)
        rough = np.zeros((padded,), np.float32)
        for i, m in enumerate(self._m):
            mtype[i] = m.type
            albedo[i] = m.color
            emit[i] = m.emit
            rough[i] = m.roughness
        return Scene.from_arrays(verts[0], verts[1], verts[2], mtype, albedo,
                                 emit, rough, n, device=device)


# Cornell-box quad corners shared by both example scenes.
_FLOOR = ((552.8, 0, 0), (0, 0, 0), (0, 0, 559.2), (549.6, 0, 559.2))
_LIGHT = ((343, 548.7, 227), (343, 548.7, 332), (213, 548.7, 332),
          (213, 548.7, 227))
_CEILING = ((556, 548.8, 0), (0, 548.8, 0), (0, 548.8, 559.2),
            (556.0, 548.8, 559.2))
_BACK = ((549.6, 0, 559.2), (0, 0, 559.2), (0, 548.8, 559.2),
         (556, 548.8, 559.2))
_FRONT = ((556, 0, 0), (0, 0, 0), (0, 548.8, 0), (556, 548.8, 0))
_RIGHT = ((0, 0, 559.2), (0, 0, 0), (0, 548.8, 0), (0, 548.8, 559.2))
_LEFT = ((552.8, 0, 0), (549.6, 0, 559.2), (556, 548.8, 559.2),
         (556, 548.8, 0))

_SHORT_BOX = (
    ((130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114)),
    ((290, 0, 114), (290, 165, 114), (240, 165, 272), (240, 0, 272)),
    ((130, 0, 65), (130, 165, 65), (290, 165, 114), (290, 0, 114)),
    ((82, 0, 225), (82, 165, 225), (130, 165, 65), (130, 0, 65)),
    ((240, 0, 272), (240, 165, 272), (82, 165, 225), (82, 0, 225)),
)
_TALL_BOX = (
    ((423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406)),
    ((423, 0, 247), (423, 330, 247), (472, 330, 406), (472, 0, 406)),
    ((472, 0, 406), (472, 330, 406), (314, 330, 456), (314, 0, 456)),
    ((314, 0, 456), (314, 330, 456), (265, 330, 296), (265, 0, 296)),
    ((265, 0, 296), (265, 330, 296), (423, 330, 247), (423, 0, 247)),
)


def cornell_box(res=(1024, 1024), device="cuda") -> Tuple[Camera, Scene]:
    """The standard Cornell box (32 triangles), on ``device``."""
    white, light = Diffuse(1), Emit(1)
    green, red = Diffuse(0, 1, 0), Diffuse(1, 0, 0)

    sb = SceneBuilder()
    sb.add_quad(_FLOOR, white)
    sb.add_quad(_LIGHT, light)
    sb.add_quad(_CEILING, white)
    sb.add_quad(_BACK, white)
    sb.add_quad(_RIGHT, green)
    sb.add_quad(_LEFT, red)
    for q in _SHORT_BOX:
        sb.add_quad(q, white)
    for q in _TALL_BOX:
        sb.add_quad(q, white, fan=True)

    cam = make_camera((278, 278, -500), (0, 0, 1), (0, 1, 0), res,
                      60 * DEG2RAD, 1.0, device=device)
    return cam, sb.build(device=device)


def modified_cornell(roughness: float, res=(1024, 1024),
                     device="cuda") -> Tuple[Camera, Scene]:
    """Specular-walled Cornell variant: all six walls SPECULAR white at the
    given roughness, short box red, tall box green, diagonal camera; on
    ``device``."""
    walls = Specular(roughness)
    light = Emit(1)
    red, green = Diffuse(1, 0, 0), Diffuse(0, 1, 0)

    sb = SceneBuilder()
    sb.add_quad(_FLOOR, walls)
    sb.add_quad(_LIGHT, light)
    sb.add_quad(_CEILING, walls)
    sb.add_quad(_BACK, walls)
    sb.add_quad(_FRONT, walls)
    sb.add_quad(_RIGHT, walls)
    sb.add_quad(_LEFT, walls)
    for q in _SHORT_BOX:
        sb.add_quad(q, red)
    for q in _TALL_BOX:
        sb.add_quad(q, green, fan=True)

    cam = make_camera((100, 400, 0), (0.5, -0.5, 1), (0, 1, 0), res,
                      80 * DEG2RAD, 1.0, device=device)
    return cam, sb.build(device=device)


def corner_scene(res=(512, 512), device="cuda") -> Tuple[Camera, Scene]:
    """3-triangle corner fixture: two diffuse triangles and one emissive,
    viewed from (1.8, 1.8, 1.8); on ``device``."""
    sb = SceneBuilder()
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), Diffuse(1))
    sb.add_triangle((0, 0, 0), (0, 0, 1), (0, 1, 0), Diffuse(0, 1, 0))
    sb.add_triangle((0, 0, 0), (1, 0, 0), (0, 0, 1),
                    HostMaterial(mat.EMIT, color=(0, 0, 1), emit=(1, 1, 1)))
    cam = make_camera((1.8, 1.8, 1.8), (-1, -1, -1), (0, 1, 0), res,
                      60 * DEG2RAD, 1.0, device=device)
    return cam, sb.build(device=device)
