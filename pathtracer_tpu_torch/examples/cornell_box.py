"""Standard Cornell box render.

Usage:  python -m pathtracer_tpu_torch.examples.cornell_box out.png
        [--res 1024] [--spp 10000] [--depth 5] [--backend auto]
        [--device cuda]

The reference renders 1024x1024 at 10,000 spp, depth 5.
"""

import argparse

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.examples._device import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("filename")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=10000)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--backend", default="auto")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    cam, scene = pt.cornell_box(res=(args.res, args.res), device=args.device)
    pt.render(cam, scene, args.spp, args.depth, args.filename,
              backend=args.backend)


if __name__ == "__main__":
    main()
