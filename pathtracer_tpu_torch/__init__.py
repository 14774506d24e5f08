"""pathtracer_tpu_torch — the PyTorch / CUDA port of ``pathtracer_tpu``.

Typical use, on an NVIDIA GPU:

    import pathtracer_tpu_torch as pt
    cam, scene = pt.cornell_box(res=(1024, 1024))
    film = pt.render(cam, scene, samples=256, depth=5, filename="out.png")

Material recovery from a target film:

    from pathtracer_tpu_torch import inverse
    mats, losses = inverse.recover_materials(cam, scene, target, steps=250,
                                             samples=64, depth=4)

A render sharded over the ranks of a process group (``torchrun``):

    from pathtracer_tpu_torch.parallel import distributed, make_mesh
    from pathtracer_tpu_torch.parallel import render_film_sharded_cuda
    dev = distributed.initialize()          # from torchrun's environment
    film = render_film_sharded_cuda(make_mesh(), cam, scene, samples=256)

Large meshes take the same call:

    from pathtracer_tpu_torch import meshes
    cam, sb = meshes.sphere_in_box(50, 100)          # 9,812 triangles
    film = pt.render(cam, sb.build(), samples=64)

Cameras and scenes are built on ``device="cuda"`` unless the caller passes
another device (``device="cpu"`` for the plain PyTorch path); without a
card that default raises PyTorch's own error.  The render runs on the
device of the scene's tensors.  On a CUDA scene the
auto backend launches a hand-written kernel from ``csrc/`` (the megakernel
up to 512 triangles, the coherent-beam kernel above), built with ``nvcc`` at
first use; on a CPU scene it runs the plain PyTorch path.

Module map (each mirrors the module of the same name in pathtracer_tpu):
    linalg, rng                 L1 math and RNG
    camera, materials, scene    L2 pinhole camera, BRDF sampling, SoA scene
    image                       L3b film and PNG I/O
    bvh, clusters               SAH BVH, cluster set and beam accel builders
    meshes, obj_loader          procedural meshes, OBJ/MTL import
    ops.intersect, ops.trace    plain PyTorch intersection and bounce loop
    ops.wavefront               staged bounce pipeline over ray queues
    ops.cuda.trace_kernel       the kernels' wrappers and plain versions
    ops.cuda.cluster_kernel
    ops.cuda.beam_kernel
    render                      L4 drivers
    diff, inverse               differentiable rendering, material recovery
    parallel                    rank grid, sharded renders and train step
    realtime                    progressive-accumulation session
    cli, __main__               ``python -m pathtracer_tpu_torch``
    convert                     numpy arrays -> Camera / Scene / parameters
    utils                       timer, profiling, checkpoints, kernel build,
                                native lib
    examples                    runnable example renders
"""

from .linalg import DEG2RAD, EPS, FLOAT_INF, SHIFT_BIAS  # noqa: F401
from .camera import (  # noqa: F401
    Camera, make_camera, get_rays, rotate, move,
    FORWARD, BACKWARD, LEFT, RIGHT, UP, DOWN,
)
from .materials import EMIT, DIFFUSE, SPECULAR  # noqa: F401
from .scene import (  # noqa: F401
    Scene, SceneBuilder, HostMaterial, Diffuse, Emit, Specular,
    cornell_box, modified_cornell, corner_scene,
)
from .image import Film, psnr, read_png, write_png  # noqa: F401
from .bvh import FlatBVH, build_bvh, print_tree  # noqa: F401
from .clusters import (  # noqa: F401
    ClusterSet, BeamAccel, build_clusters, build_beam_accel,
)
from .obj_loader import load_obj, load_obj_scene  # noqa: F401
from . import meshes  # noqa: F401
from .render import (  # noqa: F401
    render, render_film, render_normals, render_debug_uv,
)
from . import diff, inverse  # noqa: F401
from .convert import (  # noqa: F401
    camera_from_arrays, scene_from_arrays, material_params_from_arrays,
)
from .realtime import RealtimeSession, render_realtime  # noqa: F401
from .utils.timer import Timer  # noqa: F401

__version__ = "0.1.0"
