"""Table gather ``out = table[idx]``: the CUDA kernels of ``csrc/gather.cu``
(two routes), their plain PyTorch version and the dispatch between them.
The shared-memory route holds the whole table in every block, staged once
a cluster of blocks by multicast bulk copies while the first indices are
already in flight; the L2 route streams tiles of indices through a
bulk-copy ring while L2, prefetched with the table, serves the random
reads (``csrc/gather.cu``'s header says why, and what each leaves out).
Each route's launch geometry is computed in C, beside its kernel;
:func:`smem_grid` reports the shared-memory route's.

Counterpart of the Pallas probe ``gather_kernel`` of
``kaolin_tpu/utils/primitives_bench.py``. The semantics are those of
``jax.jit(lambda t, i: t[i])``: a negative index wraps once (``i + n``),
then every index is clamped to ``[0, n − 1]``.
"""

import ctypes

import torch

from kaolin_tpu_torch.utils import cuda_build

__all__ = ["table_gather", "table_gather_plain", "gather_route",
           "table_gather_smem_cuda", "table_gather_l2_cuda", "smem_grid",
           "SMEM_MAX_FLOATS"]

# opt-in dynamic shared memory of one block on sm_90 (232,448 bytes), less
# the shared-memory route's 8-byte mbarrier behind the table
SMEM_MAX_FLOATS = (232_448 - 8) // 4
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_void_p]


def gather_route(n_tab):
    """The route :func:`table_gather` takes on the card for a table of
    ``n_tab`` floats: ``"smem"`` when it fits one block's shared memory
    beside the route's mbarrier (``n_tab ≤ 58,110``), else ``"l2"``. Cold,
    the shared-memory route is no slower than the L2 route at any size it
    takes (``chip_smoke.py``'s route sweep, ``PERF.md`` §6)."""
    return "smem" if n_tab <= SMEM_MAX_FLOATS else "l2"


def smem_grid(n_tab, n, device):
    """The launch :func:`table_gather_smem_cuda` makes for a table of
    ``n_tab`` floats and ``n`` indices on CUDA ``device``, as
    ``csrc/gather.cu`` computes it → (blocks a cluster, blocks, threads a
    block). Raises for what the launch would refuse."""
    fn = cuda_build.function(
        "kaolin_gather_smem_grid",
        [ctypes.c_int, ctypes.c_longlong] + [ctypes.POINTER(ctypes.c_int)] * 3)
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(torch.device(device)):
        status = fn(n_tab, n, *map(ctypes.byref, out))
    cuda_build.check(status, "kaolin_gather_smem_grid")
    return tuple(o.value for o in out)


def table_gather_plain(table, idx):
    """Plain version of the gather kernels: ``table[idx]`` with a negative
    index wrapped once and every index clamped to the table → a float
    tensor of ``idx``'s shape."""
    n = table.shape[0]
    if table.dim() != 1 or n == 0:
        raise ValueError(f"table must be 1-D and not empty, got "
                         f"{tuple(table.shape)}")
    i = idx.long()
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return table[i]


def _aligned(t):
    """``t``, or a fresh copy when its data is not 16-byte aligned (the
    kernels load 4 floats or 4 indices at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(entry, table, idx):
    n_tab = table.shape[0]
    cuda_build.require(table, "table", (n_tab,), torch.float32)
    cuda_build.require(idx, "idx", idx.shape, torch.int32)
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if not 1 <= n_tab < 2 ** 31:
        raise ValueError(f"the table must hold 1 to 2^31 - 1 floats, got "
                         f"{n_tab}")
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    if idx.numel() == 0:
        return out, False
    table, idx = _aligned(table), _aligned(idx)
    fn = cuda_build.function(entry, _ARGTYPES)
    with torch.cuda.device(table.device):
        status = fn(cuda_build.ptr(table), cuda_build.ptr(idx),
                    cuda_build.ptr(out), n_tab, idx.numel(),
                    cuda_build.stream(table))
    cuda_build.check(status, entry)
    return out, True


def table_gather_smem_cuda(table, idx):
    """The shared-memory route on the card: every block holds the whole
    table. The grid is whole clusters of four blocks (:func:`smem_grid`);
    each block multicasts its slice of the table to the cluster's blocks by
    one bulk copy on their mbarriers, while every thread's first indices
    are already being read. ``table`` (n,) float32 with ``n ≤ 58,110``,
    ``idx`` int32 of any shape, both contiguous on one CUDA device →
    float32 of ``idx``'s shape. Launches on PyTorch's current stream and does not synchronise; a
    cluster launch the card refuses raises, nothing falls back. Not used: a
    table split across the cluster and read remotely, TMA tensor maps."""
    if table.shape[0] > SMEM_MAX_FLOATS:
        raise ValueError(f"a table of {table.shape[0]} floats does not fit "
                         f"one block's shared memory beside its mbarrier "
                         f"({SMEM_MAX_FLOATS})")
    out, launched = _launch("kaolin_gather_smem", table, idx)
    table_gather_smem_cuda.launches += int(launched)
    return out


def table_gather_l2_cuda(table, idx):
    """The L2 route on the card: the table stays in device memory and L2
    serves the random reads. A persistent grid (two blocks an SM) walks
    tiles of 1,024 indices: a block reads its first tile directly, and the
    rest arrive by bulk copies through a ring of two shared-memory slots;
    each block first prefetches its slice of the table into L2 as a stream
    (a table of at most 24 MB, given at least ``n_tab / 8`` indices); a
    thread keeps two tiles' table reads in flight. Any table size;
    otherwise as :func:`table_gather_smem_cuda`. Not used: an L2
    persistence window (device-wide), sorting the indices (two more
    passes), a cluster's distributed shared memory (3.6 MB < 4 MB)."""
    out, launched = _launch("kaolin_gather_l2", table, idx)
    table_gather_l2_cuda.launches += int(launched)
    return out


table_gather_smem_cuda.launches = 0
table_gather_l2_cuda.launches = 0


def table_gather(table, idx):
    """``table[idx]`` with JAX's index rule (a negative index wraps once,
    then every index is clamped to the table).

    A CPU table takes :func:`table_gather_plain`. A CUDA table launches a
    kernel, chosen by one size rule (:func:`gather_route`): a table of at
    most 58,110 floats (232,440 bytes, one Hopper block's shared memory
    beside an 8-byte mbarrier) takes the shared-memory route, any larger
    one the L2 route. On the card ``table`` is (n,) float32 and ``idx``
    int32, contiguous; anything else raises."""
    if not table.is_cuda:
        return table_gather_plain(table, idx)
    if gather_route(table.shape[0]) == "smem":
        return table_gather_smem_cuda(table, idx)
    return table_gather_l2_cuda(table, idx)
