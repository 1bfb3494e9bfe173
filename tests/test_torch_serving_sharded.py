"""The port's service over a queue group on the host: `serve.build_service`
at the infer CLI's --smoke geometry as rank 0 of two Gloo ranks (spawned,
`tests/_torch_dist_child.py`; the other rank in `serve._follow_service`),
under a timeout of 60 s, against the same service in one process (the counterpart
of tests/test_serving.py's queue-sharded case):

* its `edit_stream` streams the one-rank service's chunks, bit for bit;
* a stream closed after its first chunk leaves both ranks free: the next
  stream is bit-equal again, and the service reports the group's size;
* the crash-resume drill (the FIFO killed from rank 0's emit callback, so
  the other rank is told within the iteration) resumes on both ranks from
  rank 0's snapshot and stitches to the uninterrupted run bit for bit.

The host's thread count is held at THREADS (the ranks take the parent's)."""

import numpy as np
import pytest
import torch

from tokensgen_tpu_torch.sharding import mesh

import _torch_dist_child as C

THREADS = 2
TIMEOUT_S = 60.0
SEED = 3
FRAMES = np.random.default_rng(0).uniform(-1, 1, size=(1, 18, 32, 48, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def results():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        svc = C.smoke_service()
        one = [c["latents"] for c in svc.edit_stream("a red car", FRAMES, 2, seed=SEED,
                                                     decode=False)]
        sharded = mesh.launch(C.service_checks, 2, (FRAMES, SEED), device="cpu",
                              timeout_s=TIMEOUT_S)
    finally:
        torch.set_num_threads(before)
    return one, sharded


def test_two_rank_edit_stream_equals_one_rank(results):
    one, sharded = results
    assert len(one) == len(sharded["stream"]) == 2
    for a, b in zip(sharded["stream"], one):
        assert a.shape == (1, 3, 16, 4, 6)
        np.testing.assert_array_equal(a, b)


def test_a_cancelled_stream_frees_both_ranks(results):
    one, sharded = results
    for a, b in zip(sharded["again"], one):
        np.testing.assert_array_equal(a, b)
    health = sharded["health"]
    assert health["queue_devices"] == 2 and health["backend"] == "cpu"
    assert health["requests"] == 2  # the closed stream is not counted as served


def test_two_rank_crash_resume_drill(results):
    _, sharded = results
    full, stitched = sharded["full"], sharded["stitched"]
    assert sorted(stitched) == sorted(full) and len(full) > 6
    for i in full:
        assert torch.equal(stitched[i], full[i]), i
