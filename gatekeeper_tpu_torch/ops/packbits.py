"""The bit-packed review download: the review's candidate mask and
autoreject mask, both bool[C, R], -> one uint8[2C, ceil(R/8)] array.

Row i < C packs mask[i] and row C + i packs autoreject[i]; byte j holds
columns 8j .. 8j+7 with column 8j in the most significant bit, the unused
low bits of a row's last byte 0.  That is exactly what
gatekeeper_tpu/ops/driver.py _packed_variant returns,
``jnp.packbits(jnp.concatenate([mask, autoreject], 0), axis=1)``, and what
``np.unpackbits(..., axis=1)`` undoes on the host.

``pack_review_masks`` launches the hand-written CUDA kernel K10
(kernels/packbits.cu) on CUDA masks and runs ``pack_review_masks_plain``
on CPU masks.  On a review K9 runs the same pack (kernels/packbits.cuh)
at the end of its own launch (ops/program.py ``program_eval``'s
``pack``), and K10 launches only where K9 does not pack.
``unpack_review_masks`` is the host side of the download, for one device or a
mesh's row slabs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import device as _dev

# the value of each of a byte's 8 columns, column 8j first
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_review_masks_plain(mask: torch.Tensor,
                            autoreject: torch.Tensor) -> torch.Tensor:
    both = torch.cat([mask, autoreject], dim=0)
    rows, R = both.shape
    R8 = -(-R // 8)
    padded = torch.zeros((rows, R8 * 8), dtype=torch.int32,
                         device=both.device)
    padded[:, :R] = both
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32,
                           device=both.device)
    return (padded.view(rows, R8, 8) * weights).sum(dim=2).to(torch.uint8)


def pack_review_masks_cuda(mask: torch.Tensor, autoreject: torch.Tensor,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K10, into ``out`` where given (else a new array)."""
    _dev.check(mask, "mask", torch.bool, 2, mask.device)
    _dev.check(autoreject, "autoreject", torch.bool, 2, mask.device)
    if autoreject.shape != mask.shape:
        raise ValueError(f"autoreject {tuple(autoreject.shape)} != mask "
                         f"{tuple(mask.shape)}")
    C, R = mask.shape
    if out is None:
        out = packed_empty(C, R, mask.device)
    _dev.check(out, "out", torch.uint8, 2, mask.device)
    if tuple(out.shape) != (2 * C, -(-R // 8)):
        raise ValueError(f"out {tuple(out.shape)} != {(2 * C, -(-R // 8))}")
    if C == 0 or R == 0:
        return out
    vec = int(mask.data_ptr() % 8 == 0 and autoreject.data_ptr() % 8 == 0
              and R % 8 == 0)
    _dev.launch(
        "packbits", mask.device, _dev.ptr(mask), _dev.ptr(autoreject), C, R,
        vec, _dev.ptr(out), _dev.stream(mask),
    )
    return out


def packed_empty(C: int, R: int, device) -> torch.Tensor:
    """The packed array of two [C, R] masks, uninitialised."""
    return torch.empty((2 * C, -(-R // 8)), dtype=torch.uint8, device=device)


def pack_review_masks(mask: torch.Tensor,
                      autoreject: torch.Tensor) -> torch.Tensor:
    """K10 on CUDA masks, the plain version on CPU masks."""
    if mask.device.type == "cpu":
        return pack_review_masks_plain(mask, autoreject)
    return pack_review_masks_cuda(mask, autoreject)


def unpack_review_masks(packed: List[np.ndarray], slab: int, crow,
                        rows: int):
    """The host side of the download -> (mask, autoreject), bool
    [len(crow), rows].  ``packed`` holds one downloaded uint8[2C,
    ceil(slab/8)] array a row slab, in row order (one array on one
    device).  ``crow`` picks the ordered constraints' rows out of the
    group-major layout: they are taken from the packed bytes, an eighth
    of the bool bytes, and then unpacked.  Each slab is unpacked to its
    own ``slab`` columns before the slabs join: a slab that is not a
    multiple of 8 columns has pad bits in its last byte, so packed bytes
    never join across slabs.  The columns are trimmed to ``rows``."""
    crow = np.asarray(crow, dtype=np.int64)
    parts = []
    for p in packed:
        c = p.shape[0] // 2
        q = p[np.concatenate([crow, crow + c])]
        # the rows of q are contiguous: one flat unpack is np.unpackbits(q,
        # axis=1), which loops per row, several times slower at one byte
        # a row
        bits = np.unpackbits(q.reshape(-1)).reshape(q.shape[0],
                                                    8 * q.shape[1])
        parts.append(bits[:, :slab])
    both = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)
    both = both[:, :rows].view(bool)
    return both[:len(crow)], both[len(crow):]
