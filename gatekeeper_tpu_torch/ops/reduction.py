"""The packed audit reduction: [C, R] candidate mask -> [C, 1+k] int32.

Column 0 is each constraint's candidate count; columns 1..k are its first
k candidate rows in ascending order, -1 padded, with k = min(K, R).  This
is exactly what gatekeeper_tpu/ops/driver.py _packed_reduction returns
(there: hierarchical stable top_k on the TPU).  ``row_offset`` is added to
every candidate row (not to the -1 padding): a mesh shard reduces its row
slab and reports global rows, shard * slab + column, as the JAX package's
shard_map bodies do after the reduction (ops/driver.py:3000-3003,
parallel/multihost.py:142-145).

``packed_reduction`` launches the hand-written CUDA kernel K4
(kernels/reduction.cu) on a CUDA mask and runs ``packed_reduction_plain``
on a CPU mask.  The plain version compacts with a cumulative sum rather
than ``torch.topk``, which does not keep tied elements in index order.
"""

from __future__ import annotations

import torch

from .. import device as _dev


def packed_reduction_plain(mask: torch.Tensor, K: int,
                           row_offset: int = 0) -> torch.Tensor:
    C, R = mask.shape
    k = min(K, R)
    counts = mask.sum(dim=1, dtype=torch.int32)
    rank = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
    keep = mask & (rank < k)
    rows, cols = keep.nonzero(as_tuple=True)
    first = torch.full((C, k), -1, dtype=torch.int32, device=mask.device)
    first[rows, rank[rows, cols].long()] = cols.to(torch.int32) + row_offset
    return torch.cat([counts[:, None], first], dim=1)


def _check_offset(R: int, row_offset: int):
    if row_offset < 0 or row_offset + R > 2 ** 31 - 1:
        raise ValueError(f"row_offset {row_offset} + {R} rows past int32")


def packed_reduction_cuda(mask: torch.Tensor, K: int,
                          row_offset: int = 0) -> torch.Tensor:
    _dev.check(mask, "mask", torch.bool, 2, mask.device)
    C, R = mask.shape
    _check_offset(R, row_offset)
    k = min(K, R)
    out = torch.empty((C, 1 + k), dtype=torch.int32, device=mask.device)
    if C == 0:
        return out
    if R == 0:
        return out.zero_()
    vec = int(mask.data_ptr() % 16 == 0 and R % 16 == 0)
    _dev.launch(
        "reduction", mask.device, _dev.ptr(mask), C, R, k, vec,
        int(row_offset), _dev.ptr(out), _dev.stream(mask),
    )
    return out


def packed_reduction(mask: torch.Tensor, K: int,
                     row_offset: int = 0) -> torch.Tensor:
    """K4 on a CUDA mask, the plain version on a CPU mask."""
    if mask.device.type == "cpu":
        _check_offset(mask.shape[1], row_offset)
        return packed_reduction_plain(mask, K, row_offset)
    return packed_reduction_cuda(mask, K, row_offset)
