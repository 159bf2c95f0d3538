"""The delta gather of the incremental audit: int8[C, 2w] before | after.

The first w columns are ``mask[:, idx]``, the dirty rows' columns of the
resident full-sweep mask; the last w are ``new``, the same rows evaluated
now.  This is gatekeeper_tpu/ops/driver.py ``_delta_fn``'s
``concatenate([old.astype(int8), new.astype(int8)], axis=1)``, without the
evaluation, which the driver runs through ``_eval`` on the w-row slice.

``delta_columns`` checks ``idx`` on the host (``delta_index``), then
launches the hand-written CUDA kernel K5 (kernels/delta.cu) for a CUDA
mask and runs ``delta_columns_plain`` for a CPU one.  On one card a delta
sweep's columns come from K9's delta mode (ops/program.py, ``delta=``) in
K9's own launch; K5 launches where no program group has rows, past
program.DELTA_IN_K9_MAX_ROWS rows, and under a mesh, once per owning
shard, whose slab of the resident mask lies on that shard's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as _dev


def delta_columns_plain(mask: torch.Tensor, idx: torch.Tensor,
                        new: torch.Tensor) -> torch.Tensor:
    old = mask.index_select(1, idx.long())
    return torch.cat([old.to(torch.int8), new.to(torch.int8)], dim=1)


def delta_columns_cuda(mask: torch.Tensor, idx: torch.Tensor,
                       new: torch.Tensor, out=None) -> torch.Tensor:
    """K5, into ``out`` where given.  ``idx`` must lie in [0, R):
    ``delta_index`` checks it."""
    dev = mask.device
    _dev.check(mask, "mask", torch.bool, 2, dev)
    _dev.check(idx, "idx", torch.int32, 1, dev)
    _dev.check(new, "new", torch.bool, 2, dev)
    C, R = mask.shape
    w = idx.shape[0]
    if tuple(new.shape) != (C, w):
        raise ValueError(f"new: {tuple(new.shape)}, expected {(C, w)}")
    if out is None:
        out = torch.empty((C, 2 * w), dtype=torch.int8, device=dev)
    else:
        _dev.check(out, "out", torch.int8, 2, dev)
        if tuple(out.shape) != (C, 2 * w):
            raise ValueError(f"out: {tuple(out.shape)}, expected "
                             f"{(C, 2 * w)}")
    if C == 0 or w == 0:
        return out
    _dev.launch(
        "delta", dev, _dev.ptr(mask), C, R, _dev.ptr(idx), w,
        _dev.ptr(new), _dev.ptr(out), _dev.stream(mask),
    )
    return out


def delta_index(idx: np.ndarray, R: int, device) -> torch.Tensor:
    """The host's int array of mask columns, checked to lie in [0, R), as
    an int32 tensor on ``device``."""
    idx = np.asarray(idx)
    if idx.ndim != 1:
        raise ValueError(f"idx: {idx.ndim}-d, expected 1-d")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= R):
        raise IndexError(f"idx outside [0, {R})")
    return torch.from_numpy(idx.astype(np.int32)).to(device)


def delta_columns(mask: torch.Tensor, idx: np.ndarray,
                  new: torch.Tensor) -> torch.Tensor:
    """K5 for a CUDA mask, the plain version for a CPU one.  ``idx`` is
    the host's int array of mask columns."""
    idx_t = delta_index(idx, mask.shape[1], mask.device)
    if mask.device.type == "cpu":
        return delta_columns_plain(mask, idx_t, new)
    return delta_columns_cuda(mask, idx_t, new)
