"""Large-mesh scene through the OBJ and BVH pipeline.

Generates a sphere-in-room mesh (9,812 triangles at the defaults), writes it
to OBJ/MTL, re-imports it with the OBJ loader, builds the SAH BVH and
renders it.  On a CUDA device the auto backend launches the coherent-beam
kernel; 'cluster' and 'bvh' keep per-pixel independent sampling.

Usage:  python -m pathtracer_tpu_torch.examples.sphere_obj out.png
        [--res 256] [--spp 64] [--depth 5] [--n-lat 50] [--n-lon 100]
        [--backend auto] [--device cuda]
"""

import argparse
import dataclasses
import os
import tempfile

import pathtracer_tpu_torch as pt
from pathtracer_tpu_torch import meshes
from pathtracer_tpu_torch.examples._device import add_device_arg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("filename")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--n-lat", type=int, default=50)
    ap.add_argument("--n-lon", type=int, default=100)
    ap.add_argument("--backend", default="auto")
    add_device_arg(ap)
    args = ap.parse_args(argv)

    cam, sb = meshes.sphere_in_box(args.n_lat, args.n_lon,
                                   device=args.device)
    with tempfile.TemporaryDirectory() as d:
        obj = os.path.join(d, "scene.obj")
        meshes.save_obj(sb, obj)
        scene = pt.load_obj_scene(obj, mtl_path=d, device=args.device)
    print(f"{scene.num_tris} triangles via OBJ round-trip")

    # The camera keeps its 512^2 image plane: a smaller res renders the
    # lower-left part of the view, as the JAX package's example does.
    cam = dataclasses.replace(cam, res=(args.res, args.res))
    bvh = pt.build_bvh(scene)
    print(f"BVH: {bvh.num_nodes} nodes, depth {bvh.depth}, "
          f"max leaf {bvh.max_leaf}")
    pt.render(cam, scene, args.spp, args.depth, args.filename, bvh=bvh,
              backend=args.backend)


if __name__ == "__main__":
    main()
