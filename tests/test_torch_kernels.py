"""The PyTorch port's CUDA histogram kernel against its plain version.

The kernel has no CPU mode: the ``cuda``-marked test skips without a card.
This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The launch-plan arithmetic around the kernel (shared-memory fit, row
chunks that ignore the node count) is plain Python and runs everywhere.
Tolerance on the card: rtol 1e-5 / atol 1e-4 on Σg/Σh (the plain version
sums in float64, the kernel in float32 per chunk); counts exact.
"""

import numpy as np
import pytest
import torch

from h2o3_tpu_torch.ops import cuda_histogram as ch

RTOL, ATOL = 1e-5, 1e-4


def _mk(n, f, k, b1, seed, frac_inactive=0.0, empty_node=None, weighted=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b1, size=(n, f)).astype(np.int32)
    nodes = rng.integers(0, k, size=n).astype(np.int32)
    if empty_node is not None:
        nodes[nodes == empty_node] = (empty_node + 1) % k
    if frac_inactive:
        nodes[rng.random(n) < frac_inactive] = -1
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32) + 0.1
    rw = rng.integers(1, 4, size=n).astype(np.float32) if weighted else None
    return bins, nodes, g, h, rw


@pytest.mark.parametrize("n_bins1,k", [(257, 16), (257, 64), (21, 8), (21, 64), (9, 1)])
def test_launch_plan_fits_and_is_node_independent(n_bins1, k):
    wpb, chunk_rows, n_chunks = ch.launch_plan(2_000_000, 28, k, n_bins1)
    assert 1 <= wpb <= 8 and ch._smem_bytes(k, n_bins1, wpb) <= ch._SMEM_LIMIT
    assert chunk_rows % 32 == 0 and chunk_rows <= ch._MAX_CHUNK_ROWS
    assert (n_chunks - 1) * chunk_rows < 2_000_000 <= n_chunks * chunk_rows
    # the row chunks (and so the float sum order) ignore the node count
    assert ch.launch_plan(2_000_000, 28, 1, n_bins1)[1:] == (chunk_rows, n_chunks)


def test_launch_plan_rejects_what_does_not_fit():
    with pytest.raises(ValueError):
        ch.launch_plan(1000, 4, 128, 257)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    for n, f, k, b1, weighted in [(100_000, 28, 64, 257, False),
                                  (70_001, 11, 8, 21, True)]:
        bins, nodes, g, h, rw = _mk(n, f, k, b1, seed=n, frac_inactive=0.3,
                                    empty_node=1, weighted=weighted)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        args = (t(np.ascontiguousarray(bins.T)), t(nodes), t(g), t(h), k, b1)
        rwt = None if rw is None else t(rw)
        a = ch.hist_nodematmul(*args, rw=rwt)
        b = ch.hist_nodematmul(*args, rw=rwt)
        ref = ch.hist_nodematmul_reference(*args, rw=rwt)
        wide = ch.hist_nodematmul(*args[:4], k + 3, b1, rw=rwt)
        assert torch.equal(a, b)
        assert torch.equal(a, wide[:k])
        assert torch.equal(a[..., 2], ref[..., 2])
        assert torch.all(a[1] == 0)
        torch.testing.assert_close(a, ref, rtol=RTOL, atol=ATOL)
