"""The port's resident row scatter (ops/scatter.py) and delta gather
(ops/delta.py), plain versions as the CPU runs them, against the JAX
package's functions on the same numpy inputs made from a seed; and K6's
staged buffer (staging_layout, stage_buffer), applied the way K6 applies
it (scatter_staged_plain), against the same function.

Tolerance 0.  JAX runs without 64-bit mode, so it holds an int64 leaf as
int32 and a float64 leaf as float32: those leaves take values that both
widths hold exactly (small integers and halves), and the JAX result is
compared after casting back to the leaf's dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gatekeeper_tpu.ops.driver import _scatter_rows_impl
from gatekeeper_tpu_torch import device
from gatekeeper_tpu_torch.ops.delta import delta_columns, delta_columns_plain
from gatekeeper_tpu_torch.ops import scatter as tscatter
from gatekeeper_tpu_torch.ops.scatter import scatter_rows, scatter_rows_plain

CAPACITY = 64


def _tree(rng, rows):
    """An audit-pack-shaped tree (review arrays, column leaves) of every
    leaf dtype the pack holds, at ranks 1, 2 and 3."""
    def ints(dtype, shape):
        return rng.integers(-50, 50, (rows,) + shape).astype(dtype)

    rv = {
        "valid": rng.random(rows) < 0.5,
        "ns_mode": ints(np.int8, ()),
        "kind": ints(np.int32, ()),
        "obj_labels": ints(np.int32, (3, 2)),
        "wide": ints(np.int64, (5,)),
    }
    cols = {
        ("spec", "containers"): {
            "tcode": ints(np.int8, (4,)),
            "sid": ints(np.int32, (4,)),
            "num": (rng.integers(-8, 8, (rows, 4)) / 2).astype(np.float64),
            "mask": rng.random((rows, 4)) < 0.5,
        },
        ("metadata", "name"): {"num": rng.integers(0, 9, rows) * 0.5},
    }
    return rv, cols


def _leaves(tree):
    rv, cols = tree
    yield from rv.items()
    for ck, leaves in cols.items():
        for leaf, a in leaves.items():
            yield (ck, leaf), a


@pytest.mark.parametrize("idx", [
    [3],                                  # w = 1
    [0, 5, 63],                           # the first and last rows
    [7, 7, 2, 7],                         # duplicates carry identical rows
    list(range(CAPACITY)),                # every row
    list(np.random.default_rng(9).permutation(CAPACITY)[:40]),
])
def test_scatter_rows_plain_equals_jax(idx):
    rng = np.random.default_rng(len(idx))
    base = _tree(rng, CAPACITY)
    idx = np.asarray(idx, np.int32)
    fresh = _tree(rng, len(idx))
    # duplicate indices must carry the same row, as the driver's do
    first = {}
    for j, r in enumerate(idx):
        first.setdefault(int(r), j)
    src = [first[int(r)] for r in idx]
    fresh = (
        {k: a[src] for k, a in fresh[0].items()},
        {ck: {leaf: a[src] for leaf, a in leaves.items()}
         for ck, leaves in fresh[1].items()},
    )
    dev_tree = (
        {k: torch.from_numpy(a.copy()) for k, a in base[0].items()},
        {ck: {leaf: torch.from_numpy(a.copy()) for leaf, a in leaves.items()}
         for ck, leaves in base[1].items()},
    )
    jax_base = (
        {k: jnp.asarray(a) for k, a in base[0].items()},
        {ck: {leaf: jnp.asarray(a) for leaf, a in leaves.items()}
         for ck, leaves in base[1].items()},
    )
    out = scatter_rows_plain(dev_tree, idx, fresh)
    assert out is dev_tree
    want = _scatter_rows_impl(jax_base, jnp.asarray(idx), fresh)
    got_leaves = dict(_leaves((out[0], out[1])))
    for key, w in _leaves(want):
        g = got_leaves[key].numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))
        assert g.dtype == dict(_leaves(base))[key].dtype


def test_scatter_rows_takes_the_plain_version_on_the_cpu():
    device.reset_launches()
    dst = {"a": torch.zeros((4, 2), dtype=torch.int32)}
    scatter_rows(dst, np.array([1, 3]), {"a": np.ones((2, 2), np.int32)})
    assert dst["a"].tolist() == [[0, 0], [1, 1], [0, 0], [1, 1]]
    assert device.launches["scatter"] == 0


@pytest.mark.parametrize("bad, err", [
    (lambda d, r: (d, np.array([4]), r), IndexError),       # past the end
    (lambda d, r: (d, np.array([-1]), r), IndexError),
    (lambda d, r: (d, np.array([1]), {"a": np.ones((1, 3), np.int32)}),
     ValueError),                                           # row shape
    (lambda d, r: (d, np.array([1]), {"a": np.ones((1, 2), np.int64)}),
     TypeError),                                            # dtype
    (lambda d, r: (d, np.array([1]), {"b": r["a"]}), ValueError),  # keys
    (lambda d, r: ({"a": d["a"].t()}, np.array([1]),
                   {"a": np.ones((1, 4), np.int32)}), ValueError),  # layout
])
def test_scatter_rows_checks_its_arguments(bad, err):
    dst = {"a": torch.zeros((4, 2), dtype=torch.int32)}
    rows = {"a": np.ones((1, 2), np.int32)}
    with pytest.raises(err):
        scatter_rows(*bad(dst, rows))


@pytest.mark.parametrize("C, R, idx, p_new", [
    (5, 40, [0, 1, 2, 3, 4, 5, 6, 39], 0.5),
    (3, 64, [9, 9, 9, 20, 20, 20, 20, 20], 0.3),   # duplicates
    (7, 100, list(range(50, 66)), 1.0),             # an all-true new
    (4, 16, [15] * 8, 0.0),                         # an all-false new
])
def test_delta_columns_plain_equals_jax(C, R, idx, p_new):
    rng = np.random.default_rng(C * 100 + R)
    mask = rng.random((C, R)) < 0.4
    idx = np.asarray(idx, np.int32)
    new = rng.random((C, len(idx))) < p_new
    want = np.asarray(jnp.concatenate(
        [jnp.asarray(mask)[:, idx].astype(jnp.int8),
         jnp.asarray(new).astype(jnp.int8)], axis=1,
    ))
    device.reset_launches()
    got = delta_columns(torch.from_numpy(mask), idx, torch.from_numpy(new))
    assert device.launches["delta"] == 0
    assert got.dtype == torch.int8 and got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        delta_columns_plain(torch.from_numpy(mask),
                            torch.from_numpy(idx), torch.from_numpy(new)),
        want,
    )


def test_delta_columns_checks_idx():
    mask = torch.zeros((2, 8), dtype=torch.bool)
    new = torch.zeros((2, 1), dtype=torch.bool)
    with pytest.raises(IndexError):
        delta_columns(mask, np.array([8]), new)
    with pytest.raises(ValueError):
        delta_columns(mask, np.zeros((1, 1), np.int32), new)


# ---------------------------------------------------------------------------
# K6's staged buffer, applied as K6 applies it, against _scatter_rows_impl
# ---------------------------------------------------------------------------


def _odd_tree(rng, rows):
    """_tree's leaves and more: units of 2 and 16 bytes, row bytes that no
    word divides (3, 5 and 7 bytes), and the leaves of a rank-3 cube."""
    rv, cols = _tree(rng, rows)

    def ints(dtype, shape):
        return rng.integers(-50, 50, (rows,) + shape).astype(dtype)

    rv.update(pair=ints(np.int8, (2,)), five=ints(np.int8, (5,)),
              seven=rng.random((rows, 7)) < 0.5,
              quad=(rng.integers(-8, 8, (rows, 2)) / 2).astype(np.float64),
              cube=ints(np.int32, (2, 3, 2)), flag8=ints(np.int8, (3, 3)))
    return rv, cols


def _at_odd_address(t):
    """A contiguous copy of ``t`` one byte into a buffer of its own."""
    n = t.numel() * t.element_size()
    buf = torch.zeros(n + 1, dtype=torch.uint8)
    out = buf[1:].view(t.dtype).view(t.shape) if t.element_size() == 1 \
        else None
    if out is None:  # wider dtypes stay aligned to their size
        return t.clone()
    out.copy_(t)
    return out


def _staged_apply(dev_tree, idx, host_rows):
    """stage_rows's buffer, made by the pure numpy functions, applied the
    way K6 does."""
    idx, pairs = tscatter._checked(dev_tree, idx, host_rows)
    dsts = [d for _p, d, _r in pairs]
    lay = tscatter.staging_layout(
        [d.data_ptr() for d in dsts],
        [d[0].numel() * d.element_size() for d in dsts], len(idx))
    buf = np.full(lay.nbytes, 0xA5, np.uint8)
    tscatter.stage_buffer(lay, idx, [r for _p, _d, r in pairs], buf)
    tscatter.scatter_staged_plain(buf, lay.n_leaves, lay.n_units,
                                  lay.n_rows, lay.idx_off, lay.unit_off,
                                  lay.rows_off, lay.stride, dsts)
    return lay


@pytest.mark.parametrize("idx", [
    [3],                                  # n = 1
    [0, 5, 63],
    [7, 7, 2, 7],                         # duplicates carry identical rows
    list(range(CAPACITY)),
    list(np.random.default_rng(4).permutation(CAPACITY)[:33]),
])
def test_staged_rows_applied_as_k6_does_equal_jax(idx):
    rng = np.random.default_rng(100 + len(idx))
    base = _odd_tree(rng, CAPACITY)
    idx = np.asarray(idx, np.int64)
    fresh = _odd_tree(rng, len(idx))
    first = {}
    src = [first.setdefault(int(r), j) for j, r in enumerate(idx)]
    fresh = ({k: a[src] for k, a in fresh[0].items()},
             {ck: {leaf: a[src] for leaf, a in leaves.items()}
              for ck, leaves in fresh[1].items()})
    dev_tree = (
        {k: torch.from_numpy(a.copy()) for k, a in base[0].items()},
        {ck: {leaf: torch.from_numpy(a.copy()) for leaf, a in leaves.items()}
         for ck, leaves in base[1].items()},
    )
    # byte leaves at odd addresses: their units are single bytes
    for k in ("ns_mode", "five", "pair"):
        dev_tree[0][k] = _at_odd_address(dev_tree[0][k])
        assert dev_tree[0][k].data_ptr() % 2 == 1
    lay = _staged_apply(dev_tree, idx, fresh)
    widths = set(lay.table[:, 3].tolist())
    assert {1, 4, 8, 16} <= widths
    want = _scatter_rows_impl(
        ({k: jnp.asarray(a) for k, a in base[0].items()},
         {ck: {leaf: jnp.asarray(a) for leaf, a in leaves.items()}
          for ck, leaves in base[1].items()}), jnp.asarray(idx), fresh)
    got = dict(_leaves(dev_tree))
    for key, w in _leaves(want):
        g = got[key].numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype))


def test_staging_layout_units_and_alignment():
    """Every byte of every leaf's row is in exactly one unit; a unit's
    width divides its leaf's row bytes and destination pointer, and its
    offset in the staged row is aligned to it; rows are 16-byte strided;
    the sections do not overlap."""
    ptrs = [4096, 4096 + 3, 8192 + 8, 12288, 16384 + 2, 20480]
    rbs = [7, 4, 24, 32, 6, 0]
    lay = tscatter.staging_layout(ptrs, rbs, 5)
    assert lay.table[:, 3].tolist() == [1, 1, 8, 16, 2, 16]
    covered = {}
    for leaf, byte in lay.units.tolist():
        ptr, off, rb, w = lay.table[leaf].tolist()
        assert byte % w == 0 and off % w == 0 and rb % w == 0
        for b in range(byte, byte + w):
            assert (leaf, b) not in covered
            covered[(leaf, b)] = True
    assert len(covered) == sum(rbs)
    assert lay.stride % 16 == 0 and lay.stride >= sum(rbs)
    assert 32 * lay.n_leaves <= lay.idx_off
    assert lay.idx_off + 8 * 5 <= lay.unit_off
    assert lay.unit_off + 8 * lay.n_units <= lay.rows_off
    assert lay.rows_off % 16 == 0 and lay.nbytes == lay.rows_off + 5 * \
        lay.stride
    assert lay.shared_bytes == 32 * 6 + 8 * lay.n_units


def test_staging_refuses_a_row_past_k6s_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        tscatter.staging_layout([1], [tscatter._MAX_SHARED], 1)
    # the largest row of byte units that fits
    units = (tscatter._MAX_SHARED - 32) // 8
    assert tscatter.staging_layout([1], [units], 1).n_units == units


def test_staged_apply_refuses_a_misaligned_unit():
    dst = torch.zeros((4, 4), dtype=torch.int32)
    lay = tscatter.staging_layout([dst.data_ptr()], [16], 1)
    buf = np.zeros(lay.nbytes, np.uint8)
    tscatter.stage_buffer(lay, [2], [np.ones((1, 4), np.int32)], buf)
    tscatter.scatter_staged_plain(buf, 1, lay.n_units, 1, lay.idx_off,
                                  lay.unit_off, lay.rows_off, lay.stride,
                                  [dst])
    assert dst[2].tolist() == [1, 1, 1, 1] and dst.sum() == 4
    table = buf[:32].view(np.int64)
    table[1] += 4  # the leaf's offset in a staged row, off its 16 bytes
    with pytest.raises(AssertionError, match="misaligned"):
        tscatter.scatter_staged_plain(buf, 1, lay.n_units, 1, lay.idx_off,
                                      lay.unit_off, lay.rows_off,
                                      lay.stride, [dst])


def test_stage_rows_stages_what_the_numpy_layout_says(monkeypatch):
    """stage_rows fills the pinned buffer through stage_buffer: the copy
    on the device is the layout's bytes (pinned memory stood in for)."""
    monkeypatch.setattr(device, "pinned_empty",
                        lambda n: torch.empty(n, dtype=torch.uint8))
    rng = np.random.default_rng(3)
    base = _odd_tree(rng, 16)
    tree = (
        {k: torch.from_numpy(a.copy()) for k, a in base[0].items()},
        {ck: {leaf: torch.from_numpy(a.copy()) for leaf, a in lv.items()}
         for ck, lv in base[1].items()})
    idx = np.array([3, 9, 3])
    fresh = _odd_tree(rng, 3)
    fresh = ({k: a[[0, 1, 0]] for k, a in fresh[0].items()},
             {ck: {leaf: a[[0, 1, 0]] for leaf, a in lv.items()}
              for ck, lv in fresh[1].items()})
    st = tscatter.stage_rows(tree, idx, fresh)
    assert st.n_rows == 3 and st.n_leaves == len(list(_leaves(base)))
    buf = st.buf.numpy()
    tscatter.scatter_staged_plain(buf, st.lay.n_leaves, st.lay.n_units, 3,
                                  st.lay.idx_off, st.lay.unit_off,
                                  st.lay.rows_off, st.lay.stride, st.leaves)
    want = dict(_leaves(base))
    for key, a in want.items():
        a = a.copy()
        a[idx] = dict(_leaves(fresh))[key]
        np.testing.assert_array_equal(dict(_leaves(tree))[key].numpy(), a)
