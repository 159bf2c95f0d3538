"""The resident row scatter: patch the dirty rows into every leaf of the
device-resident audit pack, in place.

``scatter_rows(dev_tree, idx, host_rows)`` writes ``host_rows``'s row j into
row ``idx[j]`` of the matching leaf of ``dev_tree``, for every leaf: the
function of gatekeeper_tpu/ops/driver.py ``_scatter_rows_impl``.  The JAX
version returns new arrays; this one updates the resident tensors in place,
so a caller that still needs the old contents (a base mask computed lazily
from them, say) must have computed it first.

For CUDA leaves, ``stage_rows`` stages everything the hand-written kernel
K6 (kernels/scatter.cu) reads into one pinned host buffer and copies it to
the card at once; ``scatter_staged_cuda`` then launches K6 once for all
leaves.  The buffer (``staging_layout`` its geometry, ``stage_buffer`` its
bytes; plain numpy, no pinned memory) holds:

- the leaf table, int64 [L, 4]: destination pointer, the leaf's offset in
  a staged row, its row bytes, and its unit: the widest of 16, 8, 4, 2
  and 1 bytes that divides the row bytes and the destination pointer;
- the indices, int64 [n];
- the unit table, int32 [U, 2]: for each unit of a staged row, its leaf
  and its byte offset in the leaf's row;
- the rows, row-major: row j holds every leaf's bytes of host row j, each
  leaf at an offset aligned to its unit, the row padded to 16 bytes.

K6 gives a warp one row, a lane one unit at a time.  ``scatter_staged_plain``
applies a staged buffer to CPU tensors the way K6 does (the CPU tests hold
the layout with it).  CPU leaves take ``scatter_rows_plain``, one
``index_copy_`` per leaf.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from .. import device as _dev

_ALIGN = 16
_WIDTHS = (16, 8, 4, 2, 1)
# the shared memory a K6 block may take (the H100's 227 KB): the leaf
# table and the unit table are staged there
_MAX_SHARED = 232448


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


class Layout:
    """The staged buffer's geometry: byte offsets of the indices, the unit
    table and the rows, the stride of a staged row, the total bytes, the
    leaf table (int64 [L, 4]) and the unit table (int32 [U, 2])."""

    __slots__ = ("idx_off", "unit_off", "rows_off", "stride", "nbytes",
                 "table", "units", "n_rows", "row_bytes")

    @property
    def n_leaves(self) -> int:
        return len(self.table)

    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def shared_bytes(self) -> int:
        """K6's shared memory: both tables."""
        return 32 * self.n_leaves + 8 * self.n_units


def _align(n: int, a: int = _ALIGN) -> int:
    return (n + a - 1) // a * a


def staging_layout(dst_ptrs, row_bytes, n: int) -> Layout:
    """The layout for n rows of leaves at ``dst_ptrs`` (their device
    addresses) with ``row_bytes`` bytes a row."""
    lay = Layout()
    L = len(dst_ptrs)
    table = np.zeros((L, 4), np.int64)
    units, off = [], 0
    for i, (ptr, rb) in enumerate(zip(dst_ptrs, row_bytes)):
        w = next(w for w in _WIDTHS if rb % w == 0 and ptr % w == 0)
        off = _align(off, w)
        table[i] = (ptr, off, rb, w)
        units.append(np.stack([np.full(rb // w, i), np.arange(0, rb, w)], 1))
        off += rb
    lay.table = table
    lay.units = (np.concatenate(units) if units
                 else np.zeros((0, 2))).astype(np.int32).reshape(-1, 2)
    if lay.shared_bytes > _MAX_SHARED:
        raise ValueError(f"scatter: {L} leaves and {lay.n_units} units a "
                         f"row take {lay.shared_bytes} bytes of K6's shared "
                         f"memory, more than {_MAX_SHARED}")
    lay.stride = _align(off)
    lay.idx_off = _align(32 * L)
    lay.unit_off = _align(lay.idx_off + 8 * n)
    lay.rows_off = _align(lay.unit_off + 8 * lay.n_units)
    lay.nbytes = lay.rows_off + n * lay.stride
    lay.n_rows = n
    lay.row_bytes = list(row_bytes)
    return lay


def stage_buffer(lay: Layout, idx, rows: List[np.ndarray],
                 out: np.ndarray) -> np.ndarray:
    """Write the staged buffer of ``lay`` into ``out`` (uint8, at least
    lay.nbytes): the tables, the indices and the rows, leaf i's host rows
    ``rows[i]`` ([n, ...] numpy) at its offset in every staged row."""
    n = lay.n_rows
    out[:32 * lay.n_leaves] = lay.table.reshape(-1).view(np.uint8)
    out[lay.idx_off:lay.idx_off + 8 * n] = np.asarray(
        idx, np.int64).view(np.uint8)
    out[lay.unit_off:lay.unit_off + 8 * lay.n_units] = lay.units.reshape(
        -1).view(np.uint8)
    if n == 0:
        return out
    staged = out[lay.rows_off:lay.nbytes].reshape(n, lay.stride)
    for (_ptr, off, rb, _w), r in zip(lay.table.tolist(), rows):
        staged[:, off:off + rb] = np.ascontiguousarray(r).reshape(
            n, -1).view(np.uint8)
    return out


def scatter_staged_plain(buf: np.ndarray, n_leaves: int, n_units: int,
                         n_rows: int, idx_off: int, unit_off: int,
                         rows_off: int, stride: int, leaves) -> None:
    """Apply a staged buffer the way K6 does, to CPU tensors: read the
    tables, the indices and the rows from ``buf`` alone, and copy each
    unit of each row to its leaf's destination, found by the table's
    pointer among ``leaves``.  Raises where K6's word access would be
    misaligned."""
    table = buf[:32 * n_leaves].view(np.int64).reshape(n_leaves, 4)
    idx = buf[idx_off:idx_off + 8 * n_rows].view(np.int64)
    units = buf[unit_off:unit_off + 8 * n_units].view(np.int32).reshape(
        n_units, 2)
    rows = buf[rows_off:rows_off + n_rows * stride].reshape(n_rows, stride)
    by_ptr = {t.data_ptr(): t for t in leaves}
    for leaf, byte in units.tolist():
        ptr, off, rb, w = table[leaf].tolist()
        if ptr % w or (rows_off + off + byte) % w or stride % w or rb % w:
            raise AssertionError(f"scatter: unit of {w} bytes misaligned")
        dst = by_ptr[ptr].reshape(-1).view(torch.uint8).numpy()
        cols = np.arange(byte, byte + w)
        dst[idx[:, None] * rb + cols] = rows[:, off + cols]


class Staged:
    """The staged scatter on the card: ``buf`` holds the staged buffer of
    ``lay``; ``leaves`` keeps the destinations alive while the launch may
    run."""

    __slots__ = ("buf", "lay", "leaves")

    def __init__(self, buf, lay, leaves):
        self.buf, self.lay, self.leaves = buf, lay, leaves

    @property
    def n_leaves(self) -> int:
        return self.lay.n_leaves

    @property
    def n_rows(self) -> int:
        return self.lay.n_rows

    @property
    def row_bytes(self) -> list:
        return self.lay.row_bytes


def stage_rows(dev_tree, idx, host_rows) -> Staged:
    """Stage every leaf's rows, the tables and the indices into one
    pinned buffer and start its copy to the card (on the current
    stream).  ``host_rows`` leaves are numpy arrays."""
    idx, pairs = _checked(dev_tree, idx, host_rows)
    lay = staging_layout(
        [dst.data_ptr() for _p, dst, _r in pairs],
        [math.prod(dst.shape[1:]) * dst.element_size()
         for _p, dst, _r in pairs], len(idx))
    host = _dev.pinned_empty(lay.nbytes)
    stage_buffer(lay, idx, [r for _p, _d, r in pairs], host.numpy())
    buf = host.to(pairs[0][1].device, non_blocking=True)
    return Staged(buf, lay, [dst for _p, dst, _r in pairs])


def scatter_staged_cuda(st: Staged) -> None:
    """K6: one launch writes every staged row of every leaf."""
    lay = st.lay
    if lay.n_leaves == 0 or lay.n_rows == 0 or lay.n_units == 0:
        return
    _dev.launch(
        "scatter", st.buf.device, _dev.ptr(st.buf), lay.n_leaves,
        lay.n_units, lay.n_rows, lay.idx_off, lay.unit_off, lay.rows_off,
        lay.stride, _dev.stream(st.buf),
    )


def scatter_rows(dev_tree, idx, host_rows):
    """K6 for CUDA leaves, the plain version for CPU leaves; returns
    ``dev_tree``, updated in place."""
    first = next(leaf_pairs(dev_tree, host_rows), None)
    if first is None or first[1].device.type == "cpu":
        return scatter_rows_plain(dev_tree, idx, host_rows)
    scatter_staged_cuda(stage_rows(dev_tree, idx, host_rows))
    return dev_tree
