"""The plumbing of the port's ``embedding_bag_backward`` kernel
(``repro_torch.kernels.embedding_bag.ops``) on the CPU: the row offsets
(``row_offsets``) equal numpy's ``bincount`` + ``cumsum`` of the wrapped
ids, at every row (``step`` 1) and at the kernel's tile starts, and the
vector and tile choices that the wrappers hand the kernels. Exact: these
are integers. The kernels themselves are held against their plain
versions on the card in ``tests/test_torch_cuda.py``, and the plain
versions against the JAX package in ``tests/test_torch_recsys.py``,
``tests/test_torch_recsys_zoo.py`` and ``tests/test_torch_segment.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag import ops


def _np_offsets(ids: np.ndarray, rows: int) -> np.ndarray:
    """numpy's dense row offsets of ``ids`` wrapped as ``jnp.take`` wraps
    them, the ids outside [-rows, rows) dropped: (rows + 1,)."""
    w = np.where(ids < 0, ids + rows, ids)
    w = w[(w >= 0) & (w < rows)]
    return np.concatenate([[0], np.cumsum(np.bincount(w, minlength=rows))])


def _check(ids: np.ndarray, rows: int, dtype=torch.int64):
    want = _np_offsets(ids, rows)
    t = torch.from_numpy(ids).to(dtype)
    for step in (1, 2, 7, 64, ops.MAX_TILE):
        keys, perm, ptr = ops.row_offsets(t, rows, step)
        n = -(-rows // step)
        assert ptr.dtype == torch.int64 and ptr.shape == (n + 1,)
        at = np.minimum(np.arange(n + 1) * step, rows)
        np.testing.assert_array_equal(ptr.numpy(), want[at])
        # the valid ids end at the last entry, the dropped ones after it
        assert int(ptr[-1]) == want[-1]
        assert bool((keys[int(ptr[-1]):] == rows).all())
        # each row's positions ascend and hold that row's ids
        valid = keys[:int(ptr[-1])]
        np.testing.assert_array_equal(
            np.where(t[perm[:valid.numel()]].numpy() < 0,
                     t[perm[:valid.numel()]].numpy() + rows,
                     t[perm[:valid.numel()]].numpy()), valid.numpy())
        for r in range(min(rows, 50)):
            p = perm[want[r]:want[r + 1]]
            assert bool((p[1:] > p[:-1]).all())


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_row_offsets_equal_bincount_cumsum_with_wrapped_and_dropped_ids(
        dtype):
    """Negative ids wrap; ids >= R and < -R drop; random ids over a
    sparse and a dense table."""
    rng = np.random.RandomState(0)
    _check(np.array([0, -1, 5, 9, -10, -11, 10, 3, 3, -7]), 10, dtype)
    _check(rng.randint(-1200, 1200, 5000), 1000, dtype)
    _check(rng.randint(-3, 40, 300), 37, dtype)


@pytest.mark.parametrize("ids,rows", [
    (np.zeros(0, np.int64), 6),            # no ids: every row empty
    (np.array([4, -9, 2], np.int64), 0),   # no rows: every id dropped
    (np.zeros(0, np.int64), 0),
    (np.full(1000, 3, np.int64), 8),       # all ids on one row
    (np.full(1000, -5, np.int64), 8),      # ... reached by wrapping
    (np.array([9, -9, 8, 100], np.int64), 8),   # every id dropped
])
def test_row_offsets_edges(ids, rows):
    _check(ids, rows)


def test_row_offsets_of_segment_sums_map_past_the_end():
    """``segment_sum`` maps an id outside [0, n) to n before the
    backward: those add nothing and never wrap, where a raw negative id
    would have wrapped. The offsets equal numpy's of the in-range ids,
    as ``jax.ops.segment_sum`` counts them."""
    rng = np.random.RandomState(1)
    n = 50
    ids = rng.randint(-20, n + 20, 3000)
    ids[:400] = 7
    mapped = np.where((ids >= 0) & (ids < n), ids, n)
    _check(mapped, n)
    counts = jax.ops.segment_sum(jnp.ones(ids.shape[0], jnp.int32),
                                 jnp.asarray(ids), num_segments=n)
    want = np.concatenate([[0], np.cumsum(np.asarray(counts))])
    _, _, ptr = ops.row_offsets(torch.from_numpy(mapped), n)
    np.testing.assert_array_equal(ptr.numpy(), want)


def test_row_offsets_of_long_runs_at_the_threshold():
    """Runs of LONG_RUN - 1, LONG_RUN and LONG_RUN + 1 ids on one row
    each, interleaved over the positions."""
    lengths = [ops.LONG_RUN - 1, ops.LONG_RUN, ops.LONG_RUN + 1, 1]
    ids = np.concatenate([np.full(m, 2 * i, np.int64)
                          for i, m in enumerate(lengths)])
    ids = ids[np.random.RandomState(2).permutation(ids.size)]
    _check(ids, 2 * len(lengths))
    _, _, ptr = ops.row_offsets(torch.from_numpy(ids), 2 * len(lengths))
    assert np.diff(ptr.numpy())[::2].tolist() == lengths


@pytest.mark.parametrize("el,multiples,want", [
    (2, (20, 0, 512), 4),          # DeepFM: D = 10 bf16, five 4-byte words
    (4, (72, 0, 512), 8),          # DIEN: D = 18 f32, nine 8-byte words
    (2, (32, 256, 512), 16),       # AutoInt: D = 16 bf16
    (2, (2, 2, 512), 2),           # D = 1 bf16
    (2, (20, 20, 514), 2),         # a base address 2 bytes past 16
    (4, (12, 12, 516), 4),         # D = 3 f32 at a 4-byte offset
    (4, (40, 40, 520), 8),
])
def test_vec_bytes_is_the_widest_dividing_vector(el, multiples, want):
    assert ops.vec_bytes(el, *multiples) == want


@pytest.mark.parametrize("row_vecs,n_ids,rows,want", [
    (5, 2_555_904, 33_764_352, 256),   # DeepFM's sparse table
    (9, 6_619_136, 369_664, 8),        # DIEN's dense one
    (784, 168_960, 169_984, 2),        # minibatch_lg's aggregation
    (1, 0, 100, 256),                  # no ids at all
    (4096, 1, 1, 1),
])
def test_tile_rows(row_vecs, n_ids, rows, want):
    t = ops.tile_rows(row_vecs, n_ids, rows)
    assert t == want and t & (t - 1) == 0 and 1 <= t <= ops.MAX_TILE
