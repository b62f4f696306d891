"""``FederatedBatcher.next_stacked``: one broadcast draw and one gather give
the batches of a draw per client, bit for bit.

Over pools of unequal (416/417) and equal sizes, odd batches (1, 25), a
one-point pool and C·N = 2, three consecutive draws equal, array for array,
a frozen copy of the per-client loop the port used to run, the JAX
package's ``repro.data.federated.FederatedBatcher`` and the benchmark's
reference draw ``bench.reference.radcom.batches``; the generator is left
in the loop's state. Each call returns fresh C-contiguous float32 / int32
arrays, and a client with an empty pool raises ``ValueError``.
"""
import numpy as np
import pytest

from bench.reference import radcom
from repro.data import federated as jfed
from repro_torch.data.federated import FederatedBatcher

D = 16
ROUNDS = 3
SEED = 1234567


def _loop_draws(parts, batch, rng, rounds):
    """The per-client loop ``next_stacked`` ran before the single draw."""
    out = []
    for _ in range(rounds):
        xs, ys = [], []
        for cluster in parts:
            cx, cy = [], []
            for client in cluster:
                idx = rng.integers(0, client["x"].shape[0], size=batch)
                cx.append(client["x"][idx])
                cy.append(client["y"][idx])
            xs.append(np.stack(cx))
            ys.append(np.stack(cy))
        out.append((np.stack(xs).astype(np.float32),
                    np.stack(ys).astype(np.int32)))
    return out


def _parts(sizes, x_dtype=np.float32, seed=0):
    """Clusters of clients with pools of the given sizes: 'x' (n, D),
    int64 'y', a task per client position."""
    rng = np.random.default_rng(seed)
    return [[{"x": rng.normal(size=(n, D)).astype(x_dtype),
              "y": rng.integers(0, 8, size=n).astype(np.int64),
              "task": radcom.TASKS[i % 3], "n_classes": 8}
             for i, n in enumerate(row)] for row in sizes]


# (C, N, B, pool sizes per cluster, x dtype of the pools)
CASES = {
    "unequal-416-417": (4, 3, 24, [[416, 417, 416], [417, 416, 417],
                                   [416, 416, 417], [417, 417, 416]],
                        np.float32),
    "all-equal": (2, 3, 4, [[50] * 3] * 2, np.float32),
    "B1": (3, 2, 1, [[7, 9], [11, 7], [9, 8]], np.float32),
    "B25": (2, 3, 25, [[416, 417, 30], [5, 417, 416]], np.float32),
    "one-point-pool": (2, 2, 3, [[1, 7], [7, 1]], np.float32),
    "CN2": (1, 2, 5, [[3, 1000]], np.float32),
    "float64-pools": (2, 2, 6, [[20, 21], [22, 23]], np.float64),
}


@pytest.fixture(params=list(CASES), ids=list(CASES))
def case(request):
    c, n, b, sizes, x_dtype = CASES[request.param]
    assert len(sizes) == c and all(len(row) == n for row in sizes)
    return c, n, b, _parts(sizes, x_dtype)


def test_next_stacked_equals_the_client_loop(case):
    c, n, b, parts = case
    batcher = FederatedBatcher(parts, b, seed=SEED)
    rng = np.random.default_rng(SEED)
    for (x, y), (wx, wy) in zip(
            [batcher.next_stacked() for _ in range(ROUNDS)],
            _loop_draws(parts, b, rng, ROUNDS)):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
    assert batcher._rng.bit_generator.state == rng.bit_generator.state
    # the k-th draw after the frozen ones still matches
    np.testing.assert_array_equal(batcher.next_stacked()[0],
                                  _loop_draws(parts, b, rng, 1)[0][0])


def test_next_stacked_equals_the_reference_batcher(case):
    c, n, b, parts = case
    batcher = FederatedBatcher(parts, b, seed=SEED)
    jbatcher = jfed.FederatedBatcher(parts, b, seed=SEED)
    for _ in range(ROUNDS):
        (x, y), (jx, jy) = batcher.next_stacked(), jbatcher.next_stacked()
        assert (x.dtype, y.dtype) == (jx.dtype, jy.dtype)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert (batcher._rng.bit_generator.state
            == jbatcher._rng.bit_generator.state)
    assert batcher.tasks() == jbatcher.tasks()


def test_next_stacked_equals_the_bench_reference_draw(case):
    c, n, b, parts = case
    batcher = FederatedBatcher(parts, b, seed=SEED)
    for x, y in radcom.batches(parts, b, SEED, ROUNDS):
        gx, gy = batcher.next_stacked()
        np.testing.assert_array_equal(gx, x)
        np.testing.assert_array_equal(gy.astype(np.int64), y)


def test_next_stacked_dtypes_shapes_and_layout(case):
    c, n, b, parts = case
    x, y = FederatedBatcher(parts, b, seed=SEED).next_stacked()
    assert x.dtype == np.float32 and y.dtype == np.int32
    assert x.shape == (c, n, b, D) and y.shape == (c, n, b)
    assert x.flags.c_contiguous and y.flags.c_contiguous
    assert FederatedBatcher.flatten(x).shape == (c * n * b, D)


def test_next_stacked_returns_fresh_arrays(case):
    c, n, b, parts = case
    batcher = FederatedBatcher(parts, b, seed=SEED)
    want = _loop_draws(parts, b, np.random.default_rng(SEED), ROUNDS)
    kept = []
    for wx, wy in want:
        x, y = batcher.next_stacked()
        # the writes into earlier batches reached neither the pools nor
        # this batch
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)
        for arr in (batcher._x, batcher._y, *kept):
            assert not np.shares_memory(x, arr)
            assert not np.shares_memory(y, arr)
        x[...] = np.nan
        y[...] = -1
        kept += [x, y]
    # and a later draw did not write into an earlier batch
    for x, y in zip(kept[::2], kept[1::2]):
        assert np.isnan(x).all() and (y == -1).all()


@pytest.mark.parametrize("empty", [(0, 0), (0, 1), (1, 1)])
def test_empty_client_pool_raises_at_the_draw(empty):
    sizes = [[4, 5], [6, 7]]
    sizes[empty[0]][empty[1]] = 0
    parts = _parts(sizes)
    batcher = FederatedBatcher(parts, 3, seed=SEED)
    with pytest.raises(ValueError):
        batcher.next_stacked()
    with pytest.raises(ValueError):
        jfed.FederatedBatcher(parts, 3, seed=SEED).next_stacked()
