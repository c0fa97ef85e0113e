"""The table gather's shared-memory route on the CPU: its plain version
against ``jax.jit(lambda t, i: t[i])`` at the route's edges, the wrapper's
refusals, and the route's size limit against what ``csrc/gather.cu``
allots a block.

The kernel itself, and the launch geometry it computes in C, run only on
the card (``chip_smoke.py`` holds the kernel bit for bit against
``table_gather_plain`` on these edges and prints each launch). There is no
float arithmetic in a gather, so every comparison is exact.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu_torch.utils import cuda_gather
from tests.torch_parity import ROOT
from tests.torch_parity import (  # noqa: F401
    torch_threads_per_worker,
    warm_torch_exp,
)

TOP = cuda_gather.SMEM_MAX_FLOATS
# an mbarrier phase expects at most 2^20 - 1 bytes (PTX's tx-count range)
MBARRIER_TX_MAX = (1 << 20) - 1
# tables of 1 to 5 floats, 16, 1,021 (no multiple of a cluster's 4 x 4
# floats), the probe's 2^14 and the route's two largest
TABLES = [1, 2, 3, 4, 5, 16, 1021, 1 << 14, TOP - 1, TOP]
# 1 to 4 indices, fewer than a cluster of four 512-thread blocks has
# threads, 4,099 (a grid rounded up to a whole cluster, a block without an
# index), 6,149 and 2^16
COUNTS = [1, 2, 3, 4, 2043, 4099, 6149, 1 << 16]


@pytest.fixture(scope="module")
def jax_gather():
    return jax.jit(lambda t, i: t[i])


def edge_case(n_tab, shape, seed):
    """A table of ``n_tab`` floats and indices of ``shape`` in [-n_tab,
    n_tab), every 7th moved past the table's end."""
    rng = np.random.RandomState(seed)
    table = rng.randn(n_tab).astype(np.float32)
    idx = rng.randint(-n_tab, n_tab, shape).astype(np.int32)
    idx.reshape(-1)[::7] += 3 * n_tab
    return table, idx


def assert_gathers_as_jax(jax_gather, table, idx):
    got = cuda_gather.table_gather(torch.from_numpy(table),
                                   torch.from_numpy(idx))
    want = jax_gather(jnp.asarray(table), jnp.asarray(idx))
    assert got.shape == idx.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("n_tab", TABLES)
def test_plain_gather_matches_jax_at_the_edges(jax_gather, n_tab, n):
    assert_gathers_as_jax(jax_gather, *edge_case(n_tab, (n,),
                                                 seed=n_tab * 7 + n))


@pytest.mark.parametrize("shape", [(1, 1), (2, 3, 5), (7, 1, 3), (64, 128)])
@pytest.mark.parametrize("n_tab", [1, 1021, 1 << 14])
def test_plain_gather_keeps_the_index_shape(jax_gather, n_tab, shape):
    """Indices of any shape gather into a result of that shape."""
    assert_gathers_as_jax(jax_gather, *edge_case(n_tab, shape,
                                                 seed=n_tab + len(shape)))


@pytest.mark.parametrize("n_tab,error", [(1, "CUDA"), (16, "CUDA"),
                                         (TOP, "CUDA"),
                                         (TOP + 1, "shared memory"),
                                         (1 << 20, "shared memory")])
def test_smem_wrapper_refuses_what_it_cannot_launch(n_tab, error):
    """On CPU tensors the card's wrapper raises (it never falls back to the
    plain version), as it does first for a table too large for a block's
    shared memory beside the mbarrier; nothing is launched."""
    before = cuda_gather.table_gather_smem_cuda.launches
    with pytest.raises(ValueError, match=error):
        cuda_gather.table_gather_smem_cuda(
            torch.zeros(n_tab), torch.zeros(8, dtype=torch.int32))
    assert cuda_gather.table_gather_smem_cuda.launches == before


def test_route_limit_is_what_the_kernel_allots():
    """``SMEM_MAX_FLOATS`` is the largest table ``gather.cu``'s launch takes:
    the table, padded to 8 bytes, and its 8-byte mbarrier fill at most a
    block's opt-in shared memory, and one mbarrier phase can expect all of
    its whole 16-byte vectors."""
    src = open(os.path.join(ROOT, "kaolin_tpu_torch", "utils", "csrc",
                            "gather.cu")).read()
    room = int(re.search(r"constexpr int kSmemMaxBytes = (\d+);",
                         src).group(1))
    assert "n_tab > (kSmemMaxBytes - 8) / 4" in src
    assert "return (4 * n_tab + 7) / 8 * 8;" in src
    assert TOP == (room - 8) // 4
    assert (4 * TOP + 7) // 8 * 8 + 8 <= room
    assert (4 * (TOP + 1) + 7) // 8 * 8 + 8 > room
    assert 16 * (TOP // 4) <= MBARRIER_TX_MAX
    assert cuda_gather.gather_route(TOP) == "smem"
    assert cuda_gather.gather_route(TOP + 1) == "l2"
