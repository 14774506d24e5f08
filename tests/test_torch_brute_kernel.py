"""The brute kernel's host side on the CPU (ops/cuda/brute_kernel.py) and
the differentiable path's choice of intersector (diff._intersect_brute_chunked).

On CPU tensors ``intersect_brute_cuda`` runs ``intersect_brute`` itself, so
here it must return exactly what that gives, in the rays' own shape, and
refuse what the kernel would not take before it looks at the device.  The
kernel itself is held against ``intersect_brute`` on the card
(tests/test_torch_cuda.py and the brute cases of tests/_torch_card.py's
sweep).
"""

import types

import numpy as np
import pytest
import torch

import pathtracer_tpu_torch as tpt
from pathtracer_tpu_torch import diff
from pathtracer_tpu_torch.camera import get_rays
from pathtracer_tpu_torch.ops.cuda import brute_kernel as tbr
from pathtracer_tpu_torch.ops.intersect import intersect_brute


def _cornell():
    return tpt.cornell_box(res=(8, 8), device="cpu")


def _rays(shape, seed=0):
    """Camera rays of the 8^2 Cornell box through random pixels and
    jitter, shaped ``shape`` + (3,)."""
    cam, _ = _cornell()
    gen = np.random.default_rng(seed)
    n = int(np.prod(shape))
    w = torch.from_numpy(gen.integers(0, 8, n))
    h = torch.from_numpy(gen.integers(0, 8, n))
    u = torch.from_numpy(gen.random((2, n), np.float32))
    o, d = get_rays(cam, w, h, u[0], u[1])
    return (o.contiguous().reshape(*shape, 3),
            d.contiguous().reshape(*shape, 3))


def _rows():
    _, scene = _cornell()
    return scene.v1, scene.v2, scene.v3


@pytest.mark.parametrize("shape", [(37,), (2, 3, 5), (1, 1), (0,),
                                   (3, 0, 2)])
def test_wrapper_restores_the_ray_shape(shape):
    """(..., 3) rays come back as (...,) hits, intersect_brute's bits."""
    o, d = _rays(shape)
    rows = _rows()
    before = tbr.LAUNCHES
    t, tid = tbr.intersect_brute_cuda(o, d, *rows)
    want_t, want_tid = intersect_brute(o, d, *rows)
    assert t.shape == tid.shape == shape
    assert tid.dtype == torch.int32 and t.dtype == torch.float32
    assert torch.equal(t, want_t) and torch.equal(tid, want_tid)
    assert tbr.LAUNCHES == before
    if shape == (37,):
        assert bool((tid >= 0).any())


def _nonc(x):
    """``x`` with the same values, not contiguous."""
    wide = torch.zeros((*x.shape[:-1], 6), dtype=x.dtype)
    wide[..., :3] = x
    return wide[..., :3]


REFUSALS = {
    "float64 rays": (lambda o, d, r: (o.double(), d.double(), r),
                     "float32"),
    "float64 rows": (lambda o, d, r: (o, d, (r[0].double(), *r[1:])),
                     "float32"),
    "strided rays": (lambda o, d, r: (_nonc(o), d, r), "contiguous"),
    "strided rows": (lambda o, d, r: (o, d, (r[0], _nonc(r[1]), r[2])),
                     "contiguous"),
    "rays require grad": (lambda o, d, r: (o, d.clone().requires_grad_(),
                                           r), "requires grad"),
    "rows require grad": (lambda o, d, r: (o, d, (
        r[0], r[1], r[2].clone().requires_grad_())), "requires grad"),
    "ray shapes differ": (lambda o, d, r: (o, d[:-1], r), "one shape"),
    "rays not (..., 3)": (lambda o, d, r: (o[:, :2], d[:, :2], r),
                          "one shape"),
    "no rows": (lambda o, d, r: (o, d, tuple(x[:0] for x in r)),
                "T >= 1"),
    "rows differ": (lambda o, d, r: (o, d, (r[0], r[1][:-1], r[2])),
                    "one shape"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks come before the device branch: a CPU batch is refused
    as a CUDA one would be, and nothing is launched."""
    make, match = REFUSALS[case]
    o, d = _rays((16,))
    o, d, rows = make(o, d, _rows())
    before = tbr.LAUNCHES
    with pytest.raises(ValueError, match=match):
        tbr.intersect_brute_cuda(o, d, *rows)
    assert tbr.LAUNCHES == before


def test_wrapper_refuses_a_device_other_than_cuda():
    o, d = _rays((4,))
    o, d = o.to("meta"), d.to("meta")
    rows = tuple(x.to("meta") for x in _rows())
    with pytest.raises(ValueError, match="runs on CUDA"):
        tbr.intersect_brute_cuda(o, d, *rows)


def test_cpu_scene_stays_chunked_and_plain(monkeypatch):
    """On a CPU scene the differentiable path's brute intersector is
    intersect_brute over chunks of BRUTE_PAIRS // T rays, each ray's hit
    the one a single unchunked call gives, and the kernel's wrapper is not
    called."""
    _, scene = _cornell()
    calls = []

    def counted(*args):
        calls.append(args[0].shape[0])
        return intersect_brute(*args)

    def refuse(*args):
        raise AssertionError("the kernel's wrapper on a CPU scene")

    monkeypatch.setattr(diff, "BRUTE_PAIRS", 100 * scene.padded_size)
    monkeypatch.setattr(diff, "intersect_brute", counted)
    monkeypatch.setattr(tbr, "intersect_brute_cuda", refuse)
    o, d = _rays((4, 5, 50))
    t, tid = diff._intersect_brute_chunked(scene)(o, d)
    assert calls == [100] * 10
    want_t, want_tid = intersect_brute(o, d, scene.v1, scene.v2, scene.v3)
    assert torch.equal(t, want_t) and torch.equal(tid, want_tid)
    assert t.shape == (4, 5, 50)


def test_cuda_scene_takes_one_wrapper_call_a_bounce(monkeypatch):
    """On a CUDA scene (a stand-in: the choice reads only the scene's
    device) the brute intersector is one call of the kernel's wrapper
    for the whole batch, however many chunks the CPU path would cut: the
    rays detached by diff._make_intersect and made contiguous (the
    camera's origin is an expanded view), the scene's rows as they are."""
    _, scene = _cornell()
    fake = types.SimpleNamespace(v1=scene.v1, v2=scene.v2, v3=scene.v3,
                                 device=torch.device("cuda"),
                                 padded_size=scene.padded_size)
    seen = []

    def record(o, d, v1, v2, v3):
        seen.append((o.is_contiguous() and d.is_contiguous(),
                     o.requires_grad or d.requires_grad,
                     (v1, v2, v3) == (scene.v1, scene.v2, scene.v3)))
        return intersect_brute(o, d, v1, v2, v3)

    monkeypatch.setattr(diff, "BRUTE_PAIRS", scene.padded_size)
    monkeypatch.setattr(tbr, "intersect_brute_cuda", record)
    intersect, park = diff._make_intersect(fake, "brute", None)
    o, d = _rays((3, 7))
    o = o[:1, :1].expand(3, 7, 3)
    d = d.clone().requires_grad_(True)
    t, tid = intersect(o, d)
    assert park is None and seen == [(True, False, True)]
    want_t, want_tid = intersect_brute(o, d.detach(), scene.v1, scene.v2,
                                       scene.v3)
    assert torch.equal(t, want_t) and torch.equal(tid, want_tid)
