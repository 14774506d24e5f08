"""Progressive-accumulation realtime renderer (a headless state machine),
the PyTorch counterpart of ``pathtracer_tpu/realtime.py``.

The reference's realtime viewer (render.h:219-387) is an SFML window whose
core is a state machine: a frame counter and an accumulation texture that
blends each new frame's samples as ``mix(prev, cur, 1/(frame+1))``
(shader.h:299-304) and RESETS whenever the camera moves.  This module
reproduces the state machine headlessly and scriptably, with the
reference's key bindings (WASD/arrows/space/z/r, render.h:268-359) as
methods and screenshots on demand ('p').

The blend over per-frame averages is the running mean of every sample
since the last camera move.  The accumulation film stays on the scene's
device; the only host copy is of the frame that is displayed or saved.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import rng as prng
from .camera import (BACKWARD, DOWN, FORWARD, LEFT, RIGHT, UP, Camera,
                     move, rotate)
from .image import Film
from .linalg import DEG2RAD
from .render import _auto_backend, render_film
from .scene import Scene
from .utils.profiling import trace_annotation

# The reference's bindings (render.h:276-338): arrows turn, WASD, space
# and z move; 'r' restores the first camera, 'p' takes a screenshot.
_TURNS = {"left": LEFT, "right": RIGHT, "up": UP, "down": DOWN}
_MOVES = {"w": FORWARD, "s": BACKWARD, "a": LEFT, "d": RIGHT, "space": UP,
          "z": DOWN}


def _pick_backend(camera: Camera, scene: Scene, backend: str) -> str:
    """Resolve 'auto' once for the session.  On a CUDA scene it takes
    ``render._auto_backend``'s rule: the trace kernel ("cuda") up to 512
    padded triangles, then the coherent-beam kernel ("beam", whose
    tile-correlated noise the accumulation averages away across frames),
    then "cluster" with its warning; so ``session.backend`` names the
    kernel that runs.  On a CPU scene 'auto' stays 'auto', as the JAX
    package leaves it off the TPU, and ``render_film`` resolves it to the
    plain path."""
    if backend != "auto" or scene.device.type != "cuda":
        return backend
    return _auto_backend(camera, scene)


class RealtimeSession:
    """Progressive renderer with an interactive camera (render.h:219-387).

    step() renders ``frame_samples`` fresh samples and folds them into the
    accumulation film; any camera mutation resets accumulation (frame=0),
    matching the reference's camera_changed handling (render.h:364-369).
    """

    ROTATE_ANGLE = 5 * DEG2RAD  # render.h:264
    MOVE_SPEED = 1.0            # render.h:265

    def __init__(self, camera: Camera, scene: Scene, depth: int = 5,
                 frame_samples: int = 15, *, seed: int = prng.SEED,
                 screenshot_dir: str = ".", accumulate: bool = True,
                 backend: str = "auto"):
        self.initial_camera = camera
        self.camera = camera
        self.scene = scene
        self.depth = depth
        self.frame_samples = frame_samples
        self.seed = seed
        self.screenshot_dir = screenshot_dir
        self.accumulate = accumulate
        self.backend = _pick_backend(camera, scene, backend)
        self.frame = 0
        w, h = camera.res
        self._accum = torch.zeros((h, w, 3), dtype=torch.float32,
                                  device=scene.device)

    # -- state machine ----------------------------------------------------

    def _reset(self):
        with trace_annotation("pt.realtime.reset"):
            self.frame = 0
            self._accum.zero_()

    def step(self) -> np.ndarray:
        """Render one frame batch; returns the current tone-mapped film
        (gamma 2.2, like the in-shader correction, shader.h:297).  The span
        ``pt.realtime.step`` covers the whole frame, the host copy of the
        display included."""
        with trace_annotation("pt.realtime.step"):
            cur = render_film(
                self.camera, self.scene, self.frame_samples, self.depth,
                seed=self.seed + self.frame if self.accumulate else self.seed,
                backend=self.backend, verbose=False,
            ).data
            if not self.accumulate:
                self._reset()
            with trace_annotation("pt.realtime.blend"):
                # mix(prev, cur, 1/(frame+1)) — running mean over frames
                t = 1.0 / (self.frame + 1)
                self._accum = self._accum * (1.0 - t) + cur * t
                self.frame += 1
            return self.display()

    def display(self) -> np.ndarray:
        """Current gamma-corrected film (H, W, 3) float in [0, 1], on the
        host."""
        with trace_annotation("pt.realtime.display"):
            return (torch.clamp_min(self._accum, 0.0)
                    ** (1.0 / 2.2)).cpu().numpy()

    # -- controls (render.h:276-338) --------------------------------------

    def _camera_changed(self):
        self._reset()

    def key(self, k: str) -> None:
        """Apply one key press with the reference's bindings.  The span
        ``pt.realtime.key`` covers a key that changes the camera, its
        reset included."""
        k = k.lower()
        if k == "p":
            self.screenshot()
            return
        if k not in _TURNS and k not in _MOVES and k != "r":
            return
        with trace_annotation("pt.realtime.key"):
            if k in _TURNS:
                self.camera = rotate(self.camera, _TURNS[k],
                                     self.ROTATE_ANGLE)
            elif k in _MOVES:
                self.camera = move(self.camera, _MOVES[k], self.MOVE_SPEED)
            else:
                self.camera = self.initial_camera
            self._camera_changed()

    def screenshot(self, filename: Optional[str] = None) -> str:
        """Save the current display to ``<dir>/<frame>.png``
        (render.h:339-351)."""
        if filename is None:
            os.makedirs(self.screenshot_dir, exist_ok=True)
            filename = os.path.join(self.screenshot_dir,
                                    f"{self.frame}.png")
        w, h = self.camera.res
        Film((w, h), data=torch.from_numpy(self.display())).save_png(filename)
        return filename

    @property
    def title(self) -> str:
        """Window-title string (render.h:378-381)."""
        p = self.camera.pos.detach().cpu().numpy()
        f = self.camera.forward.detach().cpu().numpy()
        return (f"pos: {p[0]:.6f}, {p[1]:.6f}, {p[2]:.6f} | "
                f"forward: {f[0]:.6f}, {f[1]:.6f}, {f[2]:.6f}")


def render_realtime(camera: Camera, scene: Scene, depth: int,
                    frame_samples: int, screenshot_dir: str,
                    *, frames: int = 30, keys: str = "",
                    backend: str = "auto", seed: int = prng.SEED,
                    accumulate: bool = True) -> RealtimeSession:
    """Headless driver: run ``frames`` steps, feeding ``keys`` one per frame
    (empty string entries = no key).  Returns the session for inspection.
    Scriptable analog of the reference's interactive loop."""
    sess = RealtimeSession(camera, scene, depth, frame_samples, seed=seed,
                           screenshot_dir=screenshot_dir,
                           accumulate=accumulate, backend=backend)
    key_list = keys.split(",") if keys else []
    for i in range(frames):
        if i < len(key_list) and key_list[i]:
            sess.key(key_list[i])
        sess.step()
    return sess


# ---------------------------------------------------------------------------
# Interactive terminal viewer
# ---------------------------------------------------------------------------

def ansi_frame(img: np.ndarray, max_cols: int = 128) -> str:
    """Render an (H, W, 3) float image in [0,1] as 24-bit ANSI half-block
    text (2 pixels per character row: upper via foreground '▀', lower via
    background).  A 'window' over any terminal, SSH included: the
    reference's SFML window (render.h:219-387) needs a display."""
    h, w = img.shape[:2]
    step = max(1, (w + max_cols - 1) // max_cols)
    small = img[::step, ::step]
    if small.shape[0] % 2:
        small = small[:-1]
    u8 = np.clip(small * 255.0, 0, 255).astype(np.uint8)
    top = u8[0::2]
    bot = u8[1::2]
    lines = []
    for tr, br in zip(top, bot):
        parts = []
        for (r1, g1, b1), (r2, g2, b2) in zip(tr, br):
            parts.append(f"\x1b[38;2;{r1};{g1};{b1}m"
                         f"\x1b[48;2;{r2};{g2};{b2}m▀")
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def run_interactive(camera: Camera, scene: Scene, depth: int = 5,
                    frame_samples: int = 4, *, backend: str = "auto",
                    seed: int = prng.SEED, screenshot_dir: str = ".",
                    max_frames: Optional[int] = None,
                    out=None) -> RealtimeSession:
    """Interactive terminal session: renders progressively and reads the
    reference's key bindings (render.h:276-338: wasd/arrows/space/z move,
    ijkl rotate stands in for the arrow-rotate pairs, r reset,
    p screenshot, q/ESC quit) from the raw terminal.  Requires a tty and
    raises ValueError otherwise (use render_realtime for scripted,
    headless runs)."""
    import select
    import sys

    out = out or sys.stdout
    if not sys.stdin.isatty():
        raise ValueError("run_interactive needs a tty; use render_realtime "
                         "for headless driving")
    import termios
    import tty

    sess = RealtimeSession(camera, scene, depth, frame_samples, seed=seed,
                           screenshot_dir=screenshot_dir, backend=backend)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    frames = 0
    try:
        tty.setcbreak(fd)
        out.write("\x1b[2J")  # clear
        while max_frames is None or frames < max_frames:
            img = sess.step()
            frames += 1
            out.write("\x1b[H" + ansi_frame(img[::-1])
                      + f"\n\x1b[0m{sess.title}  frame {sess.frame}  "
                      f"[wasd/space/z move, ijkl rotate, r reset, "
                      f"p shot, q quit]\n")
            out.flush()
            while select.select([sys.stdin], [], [], 0)[0]:
                k = sys.stdin.read(1)
                if k == "\x1b":
                    # Drain the escape sequence: arrow keys arrive as
                    # ESC [ A..D and map to the rotate bindings; a bare
                    # ESC quits.
                    seq = ""
                    while (len(seq) < 2
                           and select.select([sys.stdin], [], [], 0.01)[0]):
                        seq += sys.stdin.read(1)
                    arrow = {"[A": "up", "[B": "down",
                             "[C": "right", "[D": "left"}.get(seq)
                    if arrow is None:
                        return sess
                    sess.key(arrow)
                    continue
                if k == "q":
                    return sess
                sess.key({"i": "up", "k": "down", "j": "left",
                          "l": "right", " ": "space"}.get(k, k))
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return sess
