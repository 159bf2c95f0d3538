"""The resident row scatter: patch the dirty rows into every leaf of the
device-resident audit pack, in place.

``scatter_rows(dev_tree, idx, host_rows)`` writes ``host_rows``'s row j into
row ``idx[j]`` of the matching leaf of ``dev_tree``, for every leaf: the
function of gatekeeper_tpu/ops/driver.py ``_scatter_rows_impl``.  The JAX
version returns new arrays; this one updates the resident tensors in place,
so a caller that still needs the old contents (a base mask computed lazily
from them, say) must have computed it first.

For CUDA leaves, ``stage_rows`` gathers every leaf's rows, a table of
(destination pointer, source offset, row bytes) per leaf and the indices
into one pinned host buffer and copies it to the card at once;
``scatter_staged_cuda`` then launches the hand-written kernel K6
(kernels/scatter.cu) once for all leaves.  CPU leaves take
``scatter_rows_plain``, one ``index_copy_`` per leaf.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .. import device as _dev

_ALIGN = 16
# gridDim.y of the kernel is the leaf count
_MAX_LEAVES = 65535


def leaf_pairs(dev, host, path=()):
    """(path, device leaf, host rows) for every leaf, walking both trees
    by the device tree's keys."""
    if isinstance(dev, torch.Tensor):
        yield path, dev, host
    elif isinstance(dev, dict):
        if not isinstance(host, dict) or set(dev) != set(host):
            raise ValueError(f"scatter: the trees differ at {path}")
        for k in dev:
            yield from leaf_pairs(dev[k], host[k], path + (k,))
    elif isinstance(dev, (tuple, list)):
        if not isinstance(host, (tuple, list)) or len(dev) != len(host):
            raise ValueError(f"scatter: the trees differ at {path}")
        for i, (d, h) in enumerate(zip(dev, host)):
            yield from leaf_pairs(d, h, path + (i,))
    else:
        raise TypeError(f"scatter: {type(dev).__name__} leaf at {path}")


def _torch_dtype(rows) -> torch.dtype:
    if isinstance(rows, torch.Tensor):
        return rows.dtype
    return torch.from_numpy(np.empty(0, np.asarray(rows).dtype)).dtype


def _checked(dev_tree, idx, host_rows) -> Tuple[np.ndarray, List]:
    """The index array and the leaf pairs, after checking every shape,
    dtype, device, layout and index against the resident leaves."""
    idx = np.asarray(idx)
    if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError("scatter: idx must be a 1-d integer array")
    pairs = list(leaf_pairs(dev_tree, host_rows))
    device = None
    for path, dst, rows in pairs:
        if device is None:
            device = dst.device
        if dst.device != device:
            raise ValueError(f"scatter: leaf {path} on {dst.device}")
        if dst.dim() == 0 or not dst.is_contiguous():
            raise ValueError(f"scatter: leaf {path} is not a contiguous array")
        if tuple(rows.shape) != (len(idx),) + tuple(dst.shape[1:]):
            raise ValueError(
                f"scatter: rows of {path} are {tuple(rows.shape)}, "
                f"expected {(len(idx),) + tuple(dst.shape[1:])}"
            )
        if _torch_dtype(rows) != dst.dtype:
            raise TypeError(f"scatter: rows of {path} are not {dst.dtype}")
        if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= dst.shape[0]):
            raise IndexError(f"scatter: idx outside [0, {dst.shape[0]})")
    return idx, pairs


def scatter_rows_plain(dev_tree, idx, host_rows):
    """One ``index_copy_`` per leaf; ``host_rows`` leaves may be numpy
    arrays or tensors."""
    idx, pairs = _checked(dev_tree, idx, host_rows)
    if not pairs or not idx.size:
        return dev_tree
    idx_t = torch.from_numpy(idx.astype(np.int64)).to(pairs[0][1].device)
    for _path, dst, rows in pairs:
        dst.index_copy_(0, idx_t, torch.as_tensor(rows, device=dst.device))
    return dev_tree


class Staged:
    """The staged scatter on the card: ``buf`` holds the leaf table
    (int64 [n_leaves, 3]: destination pointer, source offset, row bytes),
    the int64 indices at ``idx_off``, then each leaf's rows.  ``leaves``
    keeps the destinations alive while the launch may run."""

    __slots__ = ("buf", "idx_off", "n_leaves", "n_rows", "leaves",
                 "row_bytes")

    def __init__(self, buf, idx_off, leaves, n_rows, row_bytes):
        self.buf = buf
        self.idx_off = idx_off
        self.leaves = leaves
        self.n_leaves = len(leaves)
        self.n_rows = n_rows
        self.row_bytes = row_bytes


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def stage_rows(dev_tree, idx, host_rows) -> Staged:
    """Gather every leaf's rows, the leaf table and the indices into one
    pinned buffer and start its copy to the card (on the current
    stream).  ``host_rows`` leaves are numpy arrays."""
    idx, pairs = _checked(dev_tree, idx, host_rows)
    if len(pairs) > _MAX_LEAVES:
        raise ValueError(f"scatter: {len(pairs)} leaves, at most {_MAX_LEAVES}")
    n = len(idx)
    idx_off = 8 * 3 * len(pairs)
    off = _align(idx_off + 8 * n)
    offsets, row_bytes = [], []
    for _path, dst, _rows in pairs:
        rb = math.prod(dst.shape[1:]) * dst.element_size()
        offsets.append(off)
        row_bytes.append(rb)
        off = _align(off + n * rb)
    host = _dev.pinned_empty(off)
    hv = host.numpy()
    table = hv[:idx_off].view(np.int64).reshape(len(pairs), 3)
    for i, (_path, dst, rows) in enumerate(pairs):
        table[i] = (dst.data_ptr(), offsets[i], row_bytes[i])
        flat = np.ascontiguousarray(rows).reshape(-1).view(np.uint8)
        hv[offsets[i]:offsets[i] + flat.size] = flat
    hv[idx_off:idx_off + 8 * n].view(np.int64)[:] = idx
    buf = host.to(pairs[0][1].device, non_blocking=True)
    return Staged(buf, idx_off, [dst for _p, dst, _r in pairs], n, row_bytes)


def scatter_staged_cuda(st: Staged) -> None:
    """K6: one launch writes every staged row of every leaf."""
    if st.n_leaves == 0 or st.n_rows == 0:
        return
    base = _dev.ptr(st.buf)
    _dev.launch(
        "scatter", st.buf.device, base, base + st.idx_off, base,
        st.n_leaves, st.n_rows, _dev.stream(st.buf),
    )


def scatter_rows(dev_tree, idx, host_rows):
    """K6 for CUDA leaves, the plain version for CPU leaves; returns
    ``dev_tree``, updated in place."""
    first = next(leaf_pairs(dev_tree, host_rows), None)
    if first is None or first[1].device.type == "cpu":
        return scatter_rows_plain(dev_tree, idx, host_rows)
    scatter_staged_cuda(stage_rows(dev_tree, idx, host_rows))
    return dev_tree
