"""Command-line interface, the PyTorch counterpart of
``pathtracer_tpu/cli.py``:

    python -m pathtracer_tpu_torch render cornell out.png --res 512 --spp 1024
    python -m pathtracer_tpu_torch render scene.obj out.png --camera 0,1,5:0,0,-1
    python -m pathtracer_tpu_torch sweep out_prefix --spp 1000
    python -m pathtracer_tpu_torch realtime cornell shots/ --frames 30 --keys w,a,p
    python -m pathtracer_tpu_torch invert cornell --steps 200 --res 64
    python -m pathtracer_tpu_torch bench [--backend cuda]

Every subcommand runs on ``--device`` (default ``cuda``, where the
hand-written kernels run); ``--device cpu`` takes the plain PyTorch path.
"""

from __future__ import annotations

import argparse

import numpy as np

RENDER_BACKENDS = ["auto", "brute", "bvh", "bvh-gather", "cluster", "cuda",
                   "beam"]


def _parse_camera(spec, res, device):
    from .camera import make_camera
    from .linalg import DEG2RAD

    parts = spec.split(":")
    pos = tuple(float(x) for x in parts[0].split(","))
    fwd = tuple(float(x) for x in parts[1].split(","))
    up = tuple(float(x) for x in parts[2].split(",")) if len(parts) > 2 \
        else (0, 1, 0)
    fov = float(parts[3]) if len(parts) > 3 else 60.0
    return make_camera(pos, fwd, up, res, fov * DEG2RAD, 1.0, device=device)


def _load_scene(name, res, camera_spec=None, roughness=0.0, device="cuda"):
    from . import scene as scene_mod
    from .obj_loader import load_obj_scene

    if name == "cornell":
        cam, sc = scene_mod.cornell_box(res=res, device=device)
    elif name == "modified-cornell":
        cam, sc = scene_mod.modified_cornell(roughness, res=res,
                                             device=device)
    elif name == "corner":
        cam, sc = scene_mod.corner_scene(res=res, device=device)
    elif name.endswith(".obj"):
        sc = load_obj_scene(name, device=device)
        if camera_spec is None:
            raise SystemExit("--camera is required for OBJ scenes")
        cam = None
    else:
        raise SystemExit(f"unknown scene: {name}")
    if camera_spec:
        cam = _parse_camera(camera_spec, res, device)
    return cam, sc


def invert_backend(scene) -> str:
    """``invert``'s 'auto': the dense test up to ``render.BRUTE_MAX``
    padded triangles; above, the cluster kernel on a CUDA scene (the
    large-scene recovery runs on it) and the plain BVH traversal on a CPU
    scene."""
    from .render import BRUTE_MAX

    if scene.padded_size <= BRUTE_MAX:
        return "brute"
    return "cluster" if scene.device.type == "cuda" else "bvh"


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the scene and the render "
                        "(default cuda; cpu runs the plain PyTorch path)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pathtracer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a scene to PNG")
    p.add_argument("scene")
    p.add_argument("filename")
    p.add_argument("--res", type=int, default=512)
    p.add_argument("--spp", type=int, default=256)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--backend", default="auto", choices=RENDER_BACKENDS)
    p.add_argument("--camera", help="pos:forward[:up[:fov_deg]] e.g. "
                                    "'278,278,-500:0,0,1'")
    p.add_argument("--roughness", type=float, default=0.0)
    p.add_argument("--checkpoint", help="resume file (.npz): created if "
                   "missing, resumed from if present")
    _device_arg(p)

    p = sub.add_parser("sweep", help="modified-Cornell roughness sweep")
    p.add_argument("prefix")
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--spp", type=int, default=10000)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--backend", default="auto")
    _device_arg(p)

    p = sub.add_parser("realtime", help="progressive render, scripted keys")
    p.add_argument("scene")
    p.add_argument("screenshot_dir")
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--frame-samples", type=int, default=15)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--keys", default="", help="comma list, one per frame")
    p.add_argument("--camera")
    p.add_argument("--interactive", action="store_true",
                   help="live ANSI terminal viewer with raw-key controls "
                        "(wasd/space/z move, ijkl rotate, r reset, p "
                        "screenshot, q quit); needs a tty")
    _device_arg(p)

    p = sub.add_parser("invert", help="inverse-rendering demo")
    p.add_argument("scene")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--target-spp", type=int, default=2048,
                   help="target-image quality: the target's own noise "
                        "floors the recovery, so it renders at high spp "
                        "through the kernels")
    p.add_argument("--lr", type=float, default=0.08)
    p.add_argument("--loss", default="paired",
                   choices=["paired", "relative", "sqrt", "mse"],
                   help="'paired' is the unbiased squared-error "
                        "surrogate (see inverse.py)")
    p.add_argument("--checkpoint", help="resume file (.npz): created if "
                   "missing, resumed from if present")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "brute", "bvh", "cluster"],
                   help="intersection backend for the differentiable "
                        "renders (auto: brute up to 512 padded triangles, "
                        "above that cluster on a CUDA scene, bvh on a CPU "
                        "one)")
    _device_arg(p)

    p = sub.add_parser("bench", help="headline throughput benchmark")
    p.add_argument("--res", type=int, default=1024)
    p.add_argument("--spp", type=int, default=512)
    p.add_argument("--depth", type=int, default=5)
    p.add_argument("--backend", default="cuda")
    _device_arg(p)

    args = ap.parse_args(argv)

    if args.cmd == "render":
        from .render import render
        cam, sc = _load_scene(args.scene, (args.res, args.res), args.camera,
                              args.roughness, args.device)
        # "bvh-gather" is the JAX package's name of the per-ray traversal.
        backend = "bvh" if args.backend == "bvh-gather" else args.backend
        render(cam, sc, args.spp, args.depth, args.filename,
               seed=args.seed, backend=backend, checkpoint=args.checkpoint)

    elif args.cmd == "sweep":
        from . import scene as scene_mod
        from .render import render
        for r in (0, 0.05, 0.1, 0.3, 0.5, 0.8):
            cam, sc = scene_mod.modified_cornell(r, res=(args.res, args.res),
                                                 device=args.device)
            render(cam, sc, args.spp, args.depth,
                   f"{args.prefix}{r:g}.png", backend=args.backend)

    elif args.cmd == "realtime":
        cam, sc = _load_scene(args.scene, (args.res, args.res), args.camera,
                              device=args.device)
        if args.interactive:
            from .realtime import run_interactive
            sess = run_interactive(cam, sc, args.depth, args.frame_samples,
                                   screenshot_dir=args.screenshot_dir)
        else:
            from .realtime import render_realtime
            sess = render_realtime(cam, sc, args.depth, args.frame_samples,
                                   args.screenshot_dir, frames=args.frames,
                                   keys=args.keys)
        print(sess.title)

    elif args.cmd == "invert":
        from .inverse import recover_materials
        from .render import render_film
        cam, sc = _load_scene(args.scene, (args.res, args.res),
                              device=args.device)
        backend = args.backend
        if backend == "auto":
            backend = invert_backend(sc)
        print("rendering target...")
        target = render_film(cam, sc, samples=args.target_spp,
                             depth=args.depth, seed=101,
                             backend="auto").data
        print("optimizing materials...")
        mats, losses = recover_materials(
            cam, sc, target, steps=args.steps,
            samples=args.spp, depth=args.depth, backend=backend,
            lr=args.lr, lr_end=args.lr * 0.05, loss=args.loss,
            checkpoint=args.checkpoint, verbose=True)
        true_alb = sc.host_materials()[1]
        got_alb = mats["albedo"][:sc.num_tris].cpu().numpy()
        err = np.abs(true_alb - got_alb).mean()
        print(f"final loss {losses[-1]:.3e}; mean |albedo error| {err:.4f}")

    elif args.cmd == "bench":
        import json

        import torch

        from . import scene as scene_mod
        from .render import render_film
        from .utils.timer import Timer
        cam, sc = scene_mod.cornell_box(res=(args.res, args.res),
                                        device=args.device)
        render_film(cam, sc, samples=32, depth=args.depth,
                    backend=args.backend)  # warm-up: build and load
        timer = Timer(sc.device)
        render_film(cam, sc, samples=args.spp, depth=args.depth,
                    backend=args.backend)
        dt = timer.seconds()
        rays = args.res * args.res * args.spp * args.depth
        dev = sc.device
        print(json.dumps({
            "rays_per_sec": rays / dt, "seconds": dt,
            "backend": args.backend, "device": str(dev),
            "card": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else None)}))


if __name__ == "__main__":
    main()
