"""Film and image I/O (L3b), the PyTorch counterpart of
``pathtracer_tpu/image.py``.

The film is an ``(H, W, 3)`` float32 tensor on the render's device, with
row h=0 at the image BOTTOM, as in the reference; ``to_u8`` flips it
vertically on the way out, so PNGs are pixel-aligned with the reference's
images.  PNGs are written by a stdlib zlib encoder (filter 0, one IDAT).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


class Film:
    """Accumulating film."""

    def __init__(self, res, data=None):
        self.width, self.height = int(res[0]), int(res[1])
        if data is None:
            data = torch.zeros((self.height, self.width, 3),
                               dtype=torch.float32)
        self.data = data  # (H, W, 3) tensor, row h=0 at the image bottom

    def __iadd__(self, other):
        self.data = self.data + (other.data if isinstance(other, Film)
                                 else other)
        return self

    def __itruediv__(self, scalar):
        self.data = self.data / scalar
        return self

    def numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def gamma_correct(self, gamma: float = 2.2) -> "Film":
        """pixels = max(pixels, 0) ** (1 / gamma)."""
        self.data = torch.clamp_min(self.data, 0.0) ** (1.0 / gamma)
        return self

    def to_u8(self) -> np.ndarray:
        """Clamp to [0, 1], scale to uint8, flip vertically."""
        d = np.clip(self.numpy(), 0.0, 1.0)
        return (d * 255.0).astype(np.uint8)[::-1]

    def save_png(self, filename: str) -> None:
        write_png(filename, self.to_u8())


def write_png(filename: str, rgb_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    h, w, _ = rgb_u8.shape
    rgb_u8 = np.ascontiguousarray(rgb_u8)
    raw = b"".join(b"\x00" + rgb_u8[i].tobytes() for i in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(filename, "wb") as f:
        f.write(png)


def read_png(filename: str) -> np.ndarray:
    """Minimal PNG reader (8-bit gray/RGB/RGBA, filters 0-4).  Returns
    (H, W, 3) uint8."""
    with open(filename, "rb") as f:
        blob = f.read()
    if blob[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{filename} is not a PNG")
    pos = 8
    w = h = bit_depth = color_type = None
    idat = b""
    while pos < len(blob):
        (ln,) = struct.unpack(">I", blob[pos:pos + 4])
        tag = blob[pos + 4:pos + 8]
        payload = blob[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if bit_depth != 8 or color_type not in (0, 2, 4, 6):
        raise ValueError(f"unsupported PNG: bit depth {bit_depth}, "
                         f"color type {color_type}")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for row in range(h):
        flt = raw[p]
        line = np.frombuffer(raw[p + 1:p + 1 + stride],
                             np.uint8).astype(np.int32)
        p += 1 + stride
        cur = np.zeros(stride, np.int32)
        if flt == 0:
            cur = line
        elif flt == 2:  # up
            cur = (line + prev) & 0xFF
        else:  # sub / average / paeth need the left neighbour, in order
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                if flt == 1:
                    pred = a
                elif flt == 3:
                    pred = (a + b) // 2
                elif flt == 4:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter {flt}")
                cur[i] = (line[i] + pred) & 0xFF
        out[row] = cur.astype(np.uint8)
        prev = cur
    img = out.reshape(h, w, nch)
    if nch == 1:
        img = np.repeat(img, 3, axis=-1)
    return img[..., :3]


def psnr(a, b, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio between two images (arrays or tensors)."""
    a = torch.as_tensor(a).detach().cpu().to(torch.float64)
    b = torch.as_tensor(b).detach().cpu().to(torch.float64)
    mse = float(torch.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * float(np.log10(peak * peak / mse))
