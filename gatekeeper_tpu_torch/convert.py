"""Carry the packed host state onto a torch device.

The system has no learned weights: its state is the packed arrays that
ops/pack.py (``ReviewPack.arrays``, ``ConstraintPack.arrays``),
ops/columns.py (the column dicts) and ops/params.py (a group's
``(params, elems, tables)``) build on the host.  These functions turn such
numpy trees into tensors on a device, dtype for dtype; numeric columns and
parameters stay float64.  The JAX package's packers build the same trees,
so a test hands both implementations identical inputs through here; for
the incremental audit it also carries the resident mask, the dirty-row
slices of the pack and another implementation's DeltaState.  On a mesh
(parallel/mesh.py) ``place`` puts a tree on each shard's device.
"""

from __future__ import annotations

import numpy as np
import torch


def state_from_numpy(tree, device):
    """dict / list / tuple of numpy arrays -> the same structure of
    tensors on ``device``.  Always a copy: the host packs are updated in
    place between sweeps, and a CPU tensor must not alias them."""
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(
            device, copy=True
        )
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    return tree


def to_device(array, device):
    """A copy of the host array ``array`` on ``device``: one pinned,
    asynchronous copy on the card (device.upload: work queued after it on
    the device's stream runs after it), a plain copy on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        from .device import upload

        return upload(array, device)
    return state_from_numpy(np.asarray(array), device)


def place(tree, device):
    """A tree of numpy arrays and tensors on ``device``: arrays are copied
    there (state_from_numpy), tensors moved, and a tensor already on
    ``device`` kept as it is, so shards that share a device share one
    copy."""
    device = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray):
        return state_from_numpy(tree, device)
    if isinstance(tree, dict):
        return {k: place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, device) for v in tree)
    return tree


def tree_nbytes(tree) -> int:
    """Bytes of every numpy array in a dict / list / tuple tree."""
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


def take_rows(tree, rows):
    """The same tree with every array cut to ``a[rows]`` (a copy): the
    dirty-row slices of a pack that a delta sweep evaluates and a row
    scatter uploads."""
    if isinstance(tree, np.ndarray):
        return tree[rows]
    if isinstance(tree, dict):
        return {k: take_rows(v, rows) for k, v in tree.items()}
    return type(tree)(take_rows(v, rows) for v in tree)


def group_params_from_numpy(group_params, device):
    """[(params, elems, tables)] -> the same on ``device``, each predicate
    table transposed from the host's [U, vocab] to [vocab, U] (the layout
    ops/vexpr.py EvalEnv and kernel K2 read)."""
    out = []
    for params, elems, tables in group_params:
        tabs = {
            pid: (
                state_from_numpy(np.ascontiguousarray(table.T), device),
                state_from_numpy(idx, device),
            )
            for pid, (table, idx) in tables.items()
        }
        out.append((
            state_from_numpy(params, device),
            state_from_numpy(elems, device),
            tabs,
        ))
    return out


def delta_state_from(src, mask, device):
    """A DeltaState of this package from another implementation's
    incremental audit state ``src`` (any object with its fields: counts,
    cand, horizon, row_cols, crow, K and the cs_epoch / layout_gen /
    store_epoch stamps) and its resident full-sweep mask ``mask`` (numpy
    bool [C_total, R]).  The mask goes onto ``device``, resolved; every
    host field is copied.  The render cache starts empty: its Results
    belong to the other implementation."""
    from .ops.deltasweep import DeltaState, MaskSource

    return DeltaState.from_restore(
        counts=np.asarray(src.counts, np.int64),
        cand=[list(map(int, c)) for c in src.cand],
        horizon=list(src.horizon),
        crow=np.asarray(src.crow, np.int64),
        K=int(src.K),
        mask_src=MaskSource.resolved(state_from_numpy(np.asarray(mask), device)),
        row_cols={int(r): np.asarray(c, bool).copy()
                  for r, c in src.row_cols.items()},
        render_cache={},
        cs_epoch=src.cs_epoch,
        layout_gen=src.layout_gen,
        store_epoch=src.store_epoch,
    )
