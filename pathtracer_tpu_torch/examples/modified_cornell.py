"""Specular-wall Cornell sweep: renders the roughness sweep
{0, 0.05, 0.1, 0.3, 0.5, 0.8} to ``<prefix><r>.png``.

Usage:  python -m pathtracer_tpu_torch.examples.modified_cornell out_prefix
        [--res 1024] [--spp 10000] [--depth 5] [--backend auto]
        [--device cuda]
"""

import argparse

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch.examples._device import add_device_arg

ROUGHNESS = [0, 0.05, 0.1, 0.3, 0.5, 0.8]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("prefix")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=10000)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--backend", default="auto")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    for r in ROUGHNESS:
        cam, scene = pt.modified_cornell(r, res=(args.res, args.res),
                                         device=args.device)
        pt.render(cam, scene, args.spp, args.depth, f"{args.prefix}{r:g}.png",
                  backend=args.backend)


if __name__ == "__main__":
    main()
