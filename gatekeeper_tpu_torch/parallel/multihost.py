"""Several processes: the audit sweep's row axis over the shards of every
process, joined with torch.distributed on gloo.

The counterpart of gatekeeper_tpu/parallel/multihost.py.  Design:

- every process replicates the inventory (the store is derived state,
  rebuilt from the API server), so no process needs another's rows to
  pack; sharding is purely a placement decision
- ``init_distributed`` joins the process group: gloo over TCP, its address
  given by the caller (``host:port`` of rank 0)
- the row axis is laid over (process, local device): process ``rank``
  holds global slabs ``rank * local_width`` .. ``+ local_width``, each
  evaluated and reduced to [C, 1+K'] on its device with global row
  indices (K4's row_offset); the [C, R] intermediates never leave a
  process
- the only data-plane crossing is an ``all_gather`` of the KB-scale
  [local_width, C, 1+K'] reductions as host tensors over gloo (gloo has
  no GPU all_gather, and NCCL refuses two ranks on one card); the merge
  is numpy either way, and every process gets the global result, so each
  can render and write status for the constraints it owns
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import audit_mesh, shard_review_side


def init_distributed(coordinator: str, num_processes: int,
                     process_id: int) -> None:
    """Join the process group (idempotent).  ``coordinator``: "host:port"
    of process 0."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
    )


def multihost_layout(device=None) -> tuple:
    """-> (this process's mesh of every visible device, its first global
    shard, the global width).  Every process must see as many devices:
    global shard = rank * local_width + local."""
    import torch.distributed as dist

    mesh = audit_mesh(None, device)
    local = int(mesh.devices.size)
    widths = [torch.zeros(1, dtype=torch.int64)
              for _ in range(dist.get_world_size())]
    dist.all_gather(widths, torch.tensor([local]))
    if any(int(w) != local for w in widths):
        raise RuntimeError(f"processes see {[int(w) for w in widths]} "
                           f"devices; the layout needs as many in each")
    return mesh, dist.get_rank() * local, dist.get_world_size() * local


def multihost_capped_sweep(driver, K: int):
    """The full capped-audit device sweep over every process's shards:
    each shard evaluates ONLY its contiguous row slab and reduces it to
    [C, 1+K'] with global row indices; an all_gather of those reductions
    replicates them to every process, and the host merge
    (ops/driver._merge_sharded_packed) gives the global capped result.
    -> (ordered, counts [C] int64, topk [C, min(K, capacity)])."""
    import torch.distributed as dist

    from ..ops.driver import _merge_sharded_packed

    with driver._lock:
        side = driver._synced_side()
        if driver._active_join_plans():
            # a join plan's key table must merge across processes too; the
            # multi-process sweep has not grown that exchange — fail loudly
            # rather than sweep with per-process tables
            raise NotImplementedError(
                "referential join plans are not supported on the "
                "multi-process audit sweep"
            )
        ap = driver._audit_pack
        if ap.n_rows == 0:
            return [], None, None
        mesh, first, width = multihost_layout(driver.device)
        shards, _target = shard_review_side(
            mesh, ap.capacity, ap.rp, ap.cols, width=width, first=first,
        )
        local, _masks = driver._sweep_shards(side, mesh, shards, K,
                                             first=first)
    mine = torch.from_numpy(local)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)  # [W, C, 1+K']: the KB-scale crossing
    allp = torch.cat(parts).numpy()
    # crow folds group-major pad rows out (driver._constraint_side)
    packed = _merge_sharded_packed(allp, min(K, ap.capacity))[side[4]]
    return side[0], packed[:, 0].astype(np.int64), packed[:, 1:]
