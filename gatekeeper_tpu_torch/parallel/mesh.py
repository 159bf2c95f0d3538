"""Several devices: shard the resource axis of the audit sweep, and of a
review batch, over a mesh.

The counterpart of gatekeeper_tpu/parallel/mesh.py.  The audit sweep is
data-parallel over resources: the review-side arrays (leading dim R) are
laid over the mesh in contiguous row slabs, one a shard, the constraint
side is placed once on each distinct device, and each shard evaluates its
own slab.  Where the JAX package compiles one SPMD executable with
shard_map and a psum, the port launches each shard's kernels on that
shard's device (device.launch enters it) and merges the small per-shard
reductions on the host.

A ``TorchMesh`` is an ordered tuple of shard devices.  It may name one
device several times: the virtual mesh, the counterpart of the JAX
package's ``--xla_force_host_platform_device_count`` (``virtual_mesh_env``
there).  ``visible_devices`` is the one way to a mesh: the visible CUDA
devices, or, when ``GK_VIRTUAL_DEVICES=n`` is set, n slots of one device
(the card, or the CPU in the tests).  Slabs on one device run the same
code that decides correctness on real devices: slab padding, per-shard
reductions with global row indices, the host merge, owning-shard scatter.
"""

from __future__ import annotations

import os
import queue as _queue
import threading as _threading
import time as _time
from typing import List, Optional

import numpy as np
import torch

from ..convert import place, to_device
from ..device import pinned_empty, select_device
from ..ops.packbits import packed_empty, unpack_review_masks
from ..util import join_thread

#: the environment variable that asks visible_devices() for n slots of one
#: device
VIRTUAL_DEVICES_ENV = "GK_VIRTUAL_DEVICES"


class MeshDispatchStall(RuntimeError):
    """A mesh dispatch exceeded the watchdog budget (either the gate never
    freed — a previous dispatch is wedged holding it — or the guarded
    enqueue itself never returned).  The driver re-shards the sweep
    narrower (TorchDriver.degrade_mesh)."""


class DispatchGate:
    """The mesh dispatch serializer, revocable.

    Hold it across every mesh enqueue so that the per-device launch order
    stays globally consistent.  On top of a plain lock it adds what the
    dispatch watchdog needs:

    - ``acquire(timeout)`` returns a token (or None on timeout) so a
      bounded wait can distinguish "busy" from "wedged";
    - ``revoke()`` abandons the current holder: the gate swaps in a fresh
      generation, so after a stuck dispatch is written off, later
      (narrower) dispatches proceed instead of queueing forever behind a
      thread that will never release.  A waiter that was already blocked
      on the OLD generation when it was revoked re-checks the generation
      after acquiring and migrates to the current one, so it never holds
      an abandoned lock while a new-generation holder dispatches.  The
      abandoned holder's own eventual release is then harmless.

    Plain ``with DISPATCH_LOCK:`` keeps working (blocking acquire of the
    current generation)."""

    def __init__(self):
        self._mu = _threading.Lock()        # guards the generation swap
        self._lock = _threading.Lock()      # the actual gate
        self._gen = 0
        self._tokens = _threading.local()   # per-thread ctx-manager stack
        self.revocations = 0                # observability (tests, stats)

    def _current(self):
        with self._mu:
            return self._lock, self._gen

    def acquire(self, timeout: Optional[float] = None):
        """-> opaque token for release(), or None when `timeout` elapsed.

        Generation-checked: if a revoke() landed while we waited, the
        lock we just acquired is the ABANDONED one — release it and
        re-acquire the current generation (within the same deadline for
        timed acquires)."""
        deadline = (
            _time.monotonic() + timeout if timeout is not None else None
        )
        while True:
            lock, gen = self._current()
            if deadline is None:
                got = lock.acquire()
            else:
                remaining = deadline - _time.monotonic()
                got = remaining > 0 and lock.acquire(timeout=remaining)
            if not got:
                return None
            with self._mu:
                if gen == self._gen:
                    return (lock, gen)
            # revoked while we waited: this lock is abandoned — drop it
            # and serialize against the CURRENT generation instead
            lock.release()

    def release(self, token):
        """Idempotent for abandoned holders: releasing a revoked
        generation's lock is safe (nothing acquires it again)."""
        lock, _gen = token
        try:
            lock.release()
        except RuntimeError:
            pass  # already released (defensive; should not happen)

    def revoke(self):
        """Abandon the current holder: fresh lock, new generation."""
        with self._mu:
            self._lock = _threading.Lock()
            self._gen += 1
            self.revocations += 1

    def locked(self) -> bool:
        return self._current()[0].locked()

    def __enter__(self):
        token = self.acquire()
        stack = getattr(self._tokens, "stack", None)
        if stack is None:
            stack = self._tokens.stack = []
        stack.append(token)
        return self

    def __exit__(self, *exc):
        self.release(self._tokens.stack.pop())
        return False


# Process-wide mesh dispatch gate: a sweep's launches on every shard are
# enqueued under it, so two threads dispatching mesh work never interleave
# their per-device launch order.
DISPATCH_LOCK = DispatchGate()


def visible_devices(device=None) -> tuple:
    """The devices a mesh may use: ``GK_VIRTUAL_DEVICES=n`` gives n slots
    of ``device`` (default: the card, as select_device); otherwise every
    visible CUDA device for a CUDA ``device``, and ``device`` alone for
    the CPU."""
    base = select_device(device)
    want = os.environ.get(VIRTUAL_DEVICES_ENV, "")
    if want:
        try:
            n = int(want)
        except ValueError:
            n = 0
        if n < 1:
            raise ValueError(
                f"{VIRTUAL_DEVICES_ENV}={want!r} is not a positive integer"
            )
        return (base,) * n
    if base.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (base,)


class TorchMesh:
    """An ordered tuple of shard devices: shard i holds row slab i.
    ``devices`` is an object array, so ``devices.size`` is the width as
    on a JAX mesh."""

    def __init__(self, devices):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs

    def distinct(self) -> List[torch.device]:
        """Each device once, in shard order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self):
        return f"TorchMesh({list(self.devices)})"


def audit_mesh(n_devices: Optional[int] = None, device=None) -> TorchMesh:
    """A mesh of the first ``n_devices`` visible devices (all of them by
    default)."""
    devs = visible_devices(device)
    n = n_devices or len(devs)
    if len(devs) < n:
        raise RuntimeError(f"need {n} devices, have {len(devs)}")
    return TorchMesh(devs[:n])


def maybe_audit_mesh(device=None) -> Optional[TorchMesh]:
    """The production mesh: data-parallel over every visible device, or
    None when only one device is visible (the single-device path)."""
    devs = visible_devices(device)
    return TorchMesh(devs) if len(devs) > 1 else None


def pad_rows(rows: int, multiple: int) -> int:
    """Smallest row count >= rows divisible by the mesh size."""
    return ((rows + multiple - 1) // multiple) * multiple


# Slab size below which pipelined_shard_commit skips the packer thread:
# slicing a few thousand rows costs microseconds, so the 2-deep pipeline
# would only add thread-spawn + queue overhead.
PIPELINE_MIN_SLAB_ROWS = 2048


def slab_rows(rows: int, mesh_size: int) -> tuple:
    """(padded row count, rows per shard) for a row axis laid over the
    mesh in contiguous slabs."""
    target = pad_rows(rows, mesh_size)
    return target, target // mesh_size


def owning_shards(rows, capacity: int, mesh_size: int) -> set:
    """The set of shard indices whose contiguous row slab holds any of
    `rows` — the shards a churn batch actually touches (everything else
    keeps its resident slab untouched)."""
    _target, slab = slab_rows(capacity, mesh_size)
    return {int(r) // slab for r in rows}


def _slab_of(x: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of a (possibly shorter) row-major host array, zero-
    padded past its end.  The in-range case is a VIEW.  Zero padding is
    inert: the match kernel ANDs every cell with the review-side `valid`
    flag, which pads to False, so a padded row can never produce a
    positive cell."""
    if hi <= x.shape[0]:
        return x[lo:hi]
    live = x[lo: min(hi, x.shape[0])]
    widths = [(0, (hi - lo) - live.shape[0])] + [(0, 0)] * (x.ndim - 1)
    return np.pad(live, widths)


def _flatten(tree, leaves: list):
    """Append the leaves of a dict / list / tuple tree to ``leaves`` in
    order -> the spec _unflatten rebuilds the tree from."""
    if isinstance(tree, dict):
        return ("d", [(k, _flatten(v, leaves)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return ("s", type(tree), [_flatten(v, leaves) for v in tree])
    leaves.append(tree)
    return ("l", len(leaves) - 1)


def _unflatten(spec, leaves: list):
    if spec[0] == "d":
        return {k: _unflatten(s, leaves) for k, s in spec[1]}
    if spec[0] == "s":
        return spec[1](_unflatten(s, leaves) for s in spec[2])
    return leaves[spec[1]]


class _Staging:
    """Two page-locked host slabs that a slab commit to the card fills in
    turn, each holding every row leaf of one shard's slab.  The copy out
    of a slot is asynchronous, so the card reads the slot after the host
    has moved on: a slot is refilled only once the committing thread has
    recorded the event of its last copy (``free``) and that event has
    completed."""

    def __init__(self, row_leaves, slab: int):
        self.layout, off = [], 0
        for x in row_leaves:
            shape = (slab,) + tuple(x.shape[1:])
            nbytes = int(np.prod(shape, dtype=np.int64)) * x.dtype.itemsize
            dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            self.layout.append((off, nbytes, dtype, shape))
            off += -(-nbytes // 16) * 16
        self.bufs = [pinned_empty(max(off, 1)) for _ in range(2)]
        self.free = [_threading.Event(), _threading.Event()]
        for ev in self.free:
            ev.set()
        self.copied: list = [None, None]

    def fill(self, slot: int, slabs, stop) -> Optional[list]:
        """Write ``slabs`` into ``slot`` once its last copy is done ->
        pinned views of them, or None when ``stop`` was set first."""
        while not self.free[slot].wait(0.05):
            if stop.is_set():
                return None
        self.free[slot].clear()
        if self.copied[slot] is not None:
            self.copied[slot].synchronize()
        views = []
        for (off, nbytes, dtype, shape), a in zip(self.layout, slabs):
            v = self.bufs[slot][off:off + nbytes].view(dtype).view(shape)
            v.numpy()[...] = a
            views.append(v)
        return views

    def copied_out(self, slot: int, dev: torch.device):
        """Record the copies just queued out of ``slot`` on ``dev``."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        self.copied[slot] = ev
        self.free[slot].set()


def pipelined_shard_commit(mesh: TorchMesh, rows: int, trees,
                           width: Optional[int] = None, first: int = 0):
    """Commit row-major host trees to the mesh slab by slab -> (a list of
    the trees, one a shard with its slab's tensors on its device, padded
    row count).

    Leaves whose leading dim == ``rows`` are cut into contiguous slabs,
    zero-padded past the end; every other leaf (vocabulary-sized tables)
    is placed once on each distinct device.  The row axis is laid over
    ``width`` slabs (default the mesh's size), of which this mesh holds
    ``first`` .. ``first + size`` (a process of a multi-process sweep
    holds its own).

    On the card, slabs go through two pinned host slots in turn
    (_Staging): a packer thread cuts and pads shard i+1's slab into one
    slot while shard i's asynchronous copy out of the other is in flight.
    Slabs of at most PIPELINE_MIN_SLAB_ROWS rows commit serially through
    the same slots: there the packing the pipeline hides costs less than
    the thread.  On the CPU every slab is a fresh copy: the host packs
    are updated in place between sweeps."""
    n = int(mesh.devices.size)
    width = n if width is None else int(width)
    target, slab = slab_rows(rows, width)
    leaves: list = []
    spec = _flatten(trees, leaves)
    row_idx = [
        i for i, x in enumerate(leaves)
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == rows
    ]
    row_set = set(row_idx)
    devices = list(mesh.devices)
    replicated = {
        dev: {i: place(x, dev) for i, x in enumerate(leaves)
              if i not in row_set}
        for dev in mesh.distinct()
    }
    row_leaves = [np.asarray(leaves[i]) for i in row_idx]
    staging = (_Staging(row_leaves, slab)
               if devices[0].type == "cuda" and row_leaves else None)
    per_shard: list = [None] * n

    def pack(s: int, stop) -> Optional[list]:
        lo = (first + s) * slab
        slabs = [_slab_of(x, lo, lo + slab) for x in row_leaves]
        if staging is None:
            return [torch.from_numpy(np.array(a)) for a in slabs]
        return staging.fill(s % 2, slabs, stop)

    def commit(s: int, payload: list):
        dev = devices[s]
        tensors = [t.to(dev, non_blocking=True) for t in payload]
        if staging is not None:
            staging.copied_out(s % 2, dev)
        mine = dict(replicated[dev])
        mine.update(zip(row_idx, tensors))
        per_shard[s] = _unflatten(spec, [mine[i] for i in range(len(leaves))])

    stop = _threading.Event()
    if slab <= PIPELINE_MIN_SLAB_ROWS or n == 1:
        for s in range(n):
            commit(s, pack(s, stop))
        return per_shard, target
    q: _queue.Queue = _queue.Queue(maxsize=1)  # pack i+1 / commit i

    def _put(item) -> bool:
        # bounded put: if the consumer died, its finally sets `stop` and
        # we bail instead of blocking forever on the full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def packer():
        try:
            for s in range(n):
                payload = pack(s, stop)
                if payload is None or not _put((s, payload)):
                    return
            _put(None)
        except BaseException as e:  # surfaced on the consumer side
            _put(e)

    t = _threading.Thread(target=packer, daemon=True, name="gk-shard-pack")
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            commit(*item)
    finally:
        stop.set()
        join_thread(t, 5.0, "shard packer")
    return per_shard, target


def shard_review_side(mesh: TorchMesh, rows: int, rv, cols, width=None,
                      first: int = 0):
    """Pad the row axis to a mesh multiple and commit the review-side trees
    slab by slab (pipelined_shard_commit) -> ([(rv, cols)] one a shard,
    padded rows)."""
    return pipelined_shard_commit(mesh, rows, (rv, cols), width=width,
                                  first=first)


def replicate_tree(mesh: TorchMesh, tree) -> list:
    """``tree`` placed once on each distinct device of the mesh -> one
    entry a shard; shards on one device share its copy."""
    per_dev = {dev: place(tree, dev) for dev in mesh.distinct()}
    return [per_dev[dev] for dev in mesh.devices]


def shard_args(mesh: TorchMesh, rows: int, args):
    """Pad the row axis to a mesh multiple and commit every argument of an
    evaluation ``(rv, cs, cols, group_params)`` -> ([(rv, cs, cols,
    group_params)] one a shard, padded rows): the review side in slabs,
    the constraint side replicated."""
    rv, cs, cols, group_params = args
    review, target = shard_review_side(mesh, rows, rv, cols)
    side = replicate_tree(mesh, (cs, group_params))
    return [(r, c, k, g) for (r, k), (c, g) in zip(review, side)], target


class ShardedMask:
    """A mesh sweep's resident [C, target] mask: one [C, slab] tensor a
    shard, in row order, each on its shard's device.  ``rows`` is the
    live width, the pack's capacity; the columns past it are slab
    padding, always False."""

    def __init__(self, slabs, rows: int):
        self.slabs = tuple(slabs)
        self.rows = int(rows)

    @classmethod
    def place(cls, host: np.ndarray, mesh: TorchMesh) -> "ShardedMask":
        """A host bool mask [C, rows] in slabs on the mesh's shards, in
        the slab geometry of a sweep at this width (slab_rows), zero
        padded past ``rows``.  Each distinct device gets its shards' slabs
        in one copy (device.upload: pinned and asynchronous on the card),
        and each slab is a contiguous view of it."""
        C, rows = host.shape
        n = int(mesh.devices.size)
        target, slab = slab_rows(rows, n)
        padded = np.zeros((C, target), bool)
        padded[:, :rows] = host
        # shard-major: shard i's slab is stacked[i], contiguous
        stacked = np.ascontiguousarray(
            padded.reshape(C, n, slab).transpose(1, 0, 2))
        slabs: list = [None] * n
        for dev in mesh.distinct():
            mine = [i for i, d in enumerate(mesh.devices) if d == dev]
            placed = to_device(stacked[mine], dev)
            for j, i in enumerate(mine):
                slabs[i] = placed[j]
        return cls(slabs, rows=rows)

    def host(self) -> np.ndarray:
        """The whole mask on the host, [C, rows]: the slabs joined in row
        order, the padding cut."""
        return np.concatenate([s.cpu().numpy() for s in self.slabs],
                              axis=1)[:, :self.rows]

    @property
    def shape(self) -> tuple:
        return (self.slabs[0].shape[0],
                sum(int(s.shape[1]) for s in self.slabs))

    @property
    def slab(self) -> int:
        return int(self.slabs[0].shape[1])

    def host_rows(self, crow) -> np.ndarray:
        """Rows ``crow`` of the whole mask on the host, [len(crow),
        target], sharing no memory with the slabs."""
        parts = []
        for s in self.slabs:
            idx = torch.as_tensor(np.asarray(crow), device=s.device)
            parts.append(s.index_select(0, idx).cpu().numpy())
        return np.concatenate(parts, axis=1)

    def host_row(self, c: int) -> np.ndarray:
        return np.concatenate([s[c].cpu().numpy() for s in self.slabs])


def _shard_evals(driver, reviews, mesh: TorchMesh, finish, pack=False):
    """The review-mode evaluation of ``reviews`` in row slabs, one a
    shard: each shard's (mask, autoreject, packed) on its device goes
    through ``finish`` there (packed: both masks packed by K9's launch
    where ``pack``, else None), and every shard's launches are queued,
    under the driver's guarded mesh dispatch, before any result is read
    -> (ordered, crow, rows, slab, [finish's tensors on the host as
    numpy] one list a shard)."""
    side, rv, cols, rows = driver._review_pack(reviews)
    shards, target = shard_review_side(mesh, rows, rv, cols)
    slab = target // int(mesh.devices.size)
    C = side[1].arrays["valid"].shape[0]
    for dev in mesh.distinct():
        driver._constraint_device(side, dev)

    def one(rv_s, cols_s, dev):
        out = packed_empty(C, slab, dev) if pack else None
        mask, autoreject = driver._eval(
            side, rv_s, cols_s, driver._constraint_device(side, dev),
            pack_out=out)
        return finish(mask, autoreject, out)

    def dispatch():
        outs = [one(rv_s, cols_s, dev)
                for (rv_s, cols_s), dev in zip(shards, mesh.devices)]
        return [[t.cpu().numpy() for t in out] for out in outs]

    out = driver._guarded_mesh_dispatch(mesh, dispatch)
    return side[0], side[4], rows, slab, out


def sharded_masks(driver, reviews, mesh: TorchMesh):
    """compute_masks, sharded over the mesh: each shard evaluates its row
    slab (match kernel + every violation-program group) on its device, and
    its K9 launch bit-packs its two masks there; each shard's download is
    unpacked to its own slab before the slabs join.  Returns (ordered,
    mask, autoreject) like TorchDriver.compute_masks, the row axis
    trimmed back to the single-device bucket so results compare bit for
    bit."""
    ordered, crow, rows, slab, outs = _shard_evals(
        driver, reviews, mesh, lambda m, a, p: (p,), pack=True)
    # crow folds the group-major pad rows out (driver._constraint_side)
    mask, rej = unpack_review_masks([p for (p,) in outs], slab, crow, rows)
    return ordered, mask, rej


def sharded_violation_counts(driver, reviews, mesh: TorchMesh):
    """Per-constraint candidate and autoreject counts with the reduction
    on each shard's device: K4's count column (K = 0) of each slab, summed
    on the host — the counterpart of the JAX package's psum; only [C]
    ints a shard cross back."""
    from ..ops.reduction import packed_reduction

    ordered, crow, _rows, _slab, outs = _shard_evals(
        driver, reviews, mesh,
        lambda m, a, _p: (packed_reduction(m, 0), packed_reduction(a, 0)))
    mask_n = sum(c[:, 0].astype(np.int64) for c, _r in outs)
    rej_n = sum(r[:, 0].astype(np.int64) for _c, r in outs)
    return ordered, mask_n[crow], rej_n[crow]
