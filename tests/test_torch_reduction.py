"""The port's packed reduction (gatekeeper_tpu_torch/ops/reduction.py, the
plain version the CPU runs) bit-equal to the JAX _packed_reduction, on
masks made from a seed with numpy.  Tolerance 0: the output is int32."""

import numpy as np
import pytest
import torch

from gatekeeper_tpu.ops.driver import _packed_reduction
from gatekeeper_tpu_torch.ops.reduction import (
    packed_reduction,
    packed_reduction_plain,
)


def _both(mask: np.ndarray, K: int):
    want = np.asarray(_packed_reduction(mask, K))
    got = packed_reduction(torch.from_numpy(mask), K).numpy()
    return want, got


@pytest.mark.parametrize(
    "C, R, K, density",
    [
        (5, 64 * 40, 3, 0.01),     # hierarchical branch (k*W*2 < R, R % W == 0)
        (5, 64 * 40, 7, 0.3),      # dense rows, first k decided early
        (4, 1000, 3, 0.05),        # R not a multiple of 64: flat branch
        (6, 256, 4, 0.2),          # flat branch by k*W*2 >= R
        (3, 4096, 1, 0.02),        # K = 1
        (3, 300, 64, 0.05),        # K above the true count: -1 padding
        (2, 50, 80, 0.5),          # K above R: width 1 + R
    ],
)
def test_packed_reduction_bit_equal(C, R, K, density):
    rng = np.random.default_rng(C * 1000 + R + K)
    mask = rng.random((C, R)) < density
    mask[0] = False  # an all-false row
    mask[-1, : min(R, 5)] = True  # ties at the very start
    want, got = _both(mask, K)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_all_true_rows_give_the_first_k_columns():
    mask = np.ones((3, 64 * 16), bool)
    want, got = _both(mask, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], 64 * 16)
    np.testing.assert_array_equal(got[:, 1:], np.tile(np.arange(5), (3, 1)))


def test_first_k_rows_ascending_with_ties():
    """torch.topk does not keep tied elements in index order; the plain
    version must, as lax.top_k does."""
    rng = np.random.default_rng(3)
    mask = rng.random((8, 2048)) < 0.4
    got = packed_reduction_plain(torch.from_numpy(mask), 32).numpy()
    for c in range(8):
        idx = got[c, 1:]
        np.testing.assert_array_equal(idx, np.nonzero(mask[c])[0][:32])
        assert (np.diff(idx) > 0).all()


# ---------------------------------------------------------------------------
# row_offset: a mesh shard's reduction in global rows
# ---------------------------------------------------------------------------


def _jax_offset(packed, offset):
    """The JAX package's offset lines after the per-shard reduction
    (gatekeeper_tpu/ops/driver.py _fused_audit_mesh_fn,
    parallel/multihost.py multihost_capped_sweep)."""
    import jax.numpy as jnp

    idx = packed[:, 1:]
    idx = jnp.where(idx >= 0, idx + offset, -1)
    return np.asarray(jnp.concatenate([packed[:, :1], idx], axis=1))


@pytest.mark.parametrize(
    "C, R, K, density, offset",
    [
        (5, 64 * 40, 3, 0.01, 0),
        (5, 64 * 40, 7, 0.3, 64 * 40 * 3),  # the fourth slab of four
        (4, 1000, 3, 0.05, 1000),           # R off the 64-row blocks
        (3, 300, 64, 0.05, 7 * 300),        # -1 padding is not offset
        (2, 50, 80, 0.5, 2 ** 31 - 1 - 50),  # the last rows int32 holds
    ],
)
def test_row_offset_bit_equal_to_the_jax_offset_lines(C, R, K, density,
                                                      offset):
    rng = np.random.default_rng(C * 7 + R + K)
    mask = rng.random((C, R)) < density
    mask[0] = False
    want = _jax_offset(_packed_reduction(mask, K), offset)
    for fn in (packed_reduction, packed_reduction_plain):
        got = fn(torch.from_numpy(mask), K, offset).numpy()
        assert got.dtype == np.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_row_offset_past_int32_is_refused():
    mask = torch.zeros((2, 10), dtype=torch.bool)
    for offset in (-1, 2 ** 31 - 10):
        with pytest.raises(ValueError, match="row_offset"):
            packed_reduction(mask, 3, offset)


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("K", [4, 32, 600])
def test_shard_reductions_merge_to_the_single_device_one(W, K):
    """Each shard's K4 with row_offset = shard * slab, merged on the host
    (the port's _merge_sharded_packed, a copy of the JAX package's): the
    single-device reduction at width min(K, R), and the JAX merge of the
    JAX per-shard reductions exactly."""
    from gatekeeper_tpu.ops.driver import _merge_sharded_packed as jmerge
    from gatekeeper_tpu_torch.ops.driver import _merge_sharded_packed
    from gatekeeper_tpu_torch.parallel.mesh import _slab_of, slab_rows

    rng = np.random.default_rng(W * 100 + K)
    C, R = 6, 512
    mask = rng.random((C, R)) < 0.08
    mask[1] = False
    mask[2, -3:] = True  # the last slab's tail
    target, slab = slab_rows(R, W)
    slabs = [_slab_of(mask.T, s * slab, (s + 1) * slab).T.copy()
             for s in range(W)]
    port = np.stack([
        packed_reduction(torch.from_numpy(m), K, s * slab).numpy()
        for s, m in enumerate(slabs)
    ])
    jax_all = np.stack([_jax_offset(_packed_reduction(m, K), s * slab)
                        for s, m in enumerate(slabs)])
    np.testing.assert_array_equal(port, jax_all)
    merged = _merge_sharded_packed(port, min(K, R))
    np.testing.assert_array_equal(merged,
                                  np.asarray(_packed_reduction(mask, K)))
    np.testing.assert_array_equal(_merge_sharded_packed(port, K),
                                  jmerge(jax_all, K))
