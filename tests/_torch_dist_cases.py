"""The multi-rank cases of tests/test_torch_parallel.py, shared with its
worker (tests/_torch_dist_worker.py), which imports no JAX.

``mesh`` is (tile, sample) over 4 ranks.  Film sizes keep the JAX
package's kernel paths legal (a power-of-two width; the Pallas kernel's
pixel count a multiple of 128) and its interpret-mode runs short."""

CASES = {
    # the plain path on (2, 2), as tests/test_parallel.py sizes it
    "plain22": dict(kind="plain", scene="corner", res=(16, 16), spp=8,
                    depth=3, seed=1, mesh=(2, 2)),
    # the trace kernel: banded on (4, 1) and (2, 2); sample-only where
    # the height (18) does not divide by the tile axis (4)
    "cuda41": dict(kind="cuda", scene="corner", res=(32, 32), spp=4,
                   depth=2, seed=7, mesh=(4, 1)),
    "cuda22": dict(kind="cuda", scene="corner", res=(32, 32), spp=4,
                   depth=2, seed=7, mesh=(2, 2)),
    "cuda_samples": dict(kind="cuda", scene="corner", res=(64, 18), spp=4,
                         depth=2, seed=7, mesh=(4, 1)),
    # the beam kernel: banded on (2, 2) (each rank's 2 tiles are one
    # square-row of the 64-wide film); sample-only at 64^2 (2 tiles)
    "beam22": dict(kind="beam", scene="corner", res=(64, 128), spp=4,
                   depth=2, seed=5, mesh=(2, 2)),
    "beam_samples": dict(kind="beam", scene="corner", res=(64, 64), spp=4,
                         depth=2, seed=3, mesh=(2, 2)),
    # the train step: 3 steps held against JAX's; 20 steps of loss fall
    "train8": dict(kind="train", scene="corner", res=(8, 8), spp=8,
                   depth=2, seed=1, mesh=(2, 2), steps=3, target_spp=16),
    "train16": dict(kind="train", scene="corner", res=(16, 16), spp=8,
                    depth=3, seed=1, mesh=(2, 2), steps=20, target_spp=16),
}
