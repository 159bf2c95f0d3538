"""The port's resident row scatter (ops/scatter.py) and delta gather
(ops/delta.py), plain versions as the CPU runs them, against the JAX
package's functions on the same numpy inputs made from a seed.

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
