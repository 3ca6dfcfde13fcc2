"""budget_route + scheduler of the PyTorch port against the JAX package,
on the CPU (the port's plain version). The JAX side runs its jnp
reference and its Pallas kernel in interpret mode. Selections, counts,
source indices and routed rows are integers or copies: held exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import scheduler as jsched
from repro.kernels.budget_route.kernel import budget_route_kernel
from repro.kernels.budget_route.ops import budget_route as j_route
from repro_torch.core import scheduler as tsched
from repro_torch.kernels.budget_route import ops as tops
from repro_torch.kernels.budget_route.ref import budget_route_ref


def _route_all(scores, tokens, alpha, kernel=True):
    """(port, jax ref[, jax interpret kernel]) outputs as numpy."""
    t = tops.budget_route(torch.from_numpy(scores),
                          torch.from_numpy(tokens), alpha)
    outs = [tuple(np.asarray(x) for x in t)]
    for fk in (False, True)[:1 + kernel]:
        j = j_route(jnp.asarray(scores), jnp.asarray(tokens), alpha,
                    force_kernel=fk)
        outs.append(tuple(np.asarray(x) for x in j))
    return outs


def _assert_same(outs):
    """idx and count equal; routed rows equal up to count (the JAX
    kernel leaves the unused rows of its output unwritten)."""
    (rows, idx, count), *rest = outs
    for r, i, c in rest:
        np.testing.assert_array_equal(idx, i)
        assert int(count) == int(c)
        np.testing.assert_array_equal(rows[:int(count)], r[:int(c)])
    assert not rows[int(count):].any()          # the port zero-fills


def _set(idx) -> set:
    idx = np.asarray(idx)
    return set(idx[idx >= 0].tolist())


def test_ties_never_displace_strictly_better():
    """The tie cases of the JAX routing tests: rows above tau are always
    kept, ties at tau fill the remaining slots in row order."""
    scores = np.array([0.3, 0.3, 0.7], np.float32)          # capacity 2
    tokens = np.arange(12, dtype=np.float32).reshape(3, 4)
    outs = _route_all(scores, tokens, 2 / 3)
    _assert_same(outs)
    assert _set(outs[0][1]) == {0, 2} and int(outs[0][2]) == 2
    assert set(tsched.plan_batch(scores, 2 / 3).expensive_idx) == {0, 2}
    # many ties before the best doc, tie budget spread across rows
    scores = np.full(80, 0.5, np.float32)
    scores[70] = 2.0
    tokens = np.random.RandomState(0).randn(80, 4).astype(np.float32)
    outs = _route_all(scores, tokens, 0.1)                   # capacity 8
    _assert_same(outs)
    plan = tsched.plan_batch(scores, 0.1)
    assert plan.expensive_idx.tolist() == [0, 1, 2, 3, 4, 5, 6, 70]
    assert _set(outs[0][1]) == set(plan.expensive_idx.tolist())
    # small JAX blocks: the tie budget carries across grid steps there
    _, idx, _ = budget_route_kernel(jnp.asarray(scores),
                                    jnp.asarray(tokens), 0.5, capacity=8,
                                    block_n=16, interpret=True)
    t_rows, t_idx, _ = budget_route_ref(torch.from_numpy(scores),
                                        torch.from_numpy(tokens),
                                        torch.tensor(0.5), capacity=8)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))


def test_capacity_clamp_at_k():
    rng = np.random.RandomState(3)
    scores = rng.randn(32).astype(np.float32)
    outs = _route_all(scores, np.zeros((32, 4), np.float32), 1.0)
    _assert_same(outs)
    want = set(np.nonzero(scores >= tsched.POSITIVE_TAU)[0].tolist())
    assert _set(outs[0][1]) == want and int(outs[0][2]) == len(want)


@pytest.mark.parametrize("k,alpha,want", [
    (100, 0.29, 29), (50, 0.58, 29), (200, 0.145, 29),
    (10, 0.7, 7), (3, 2 / 3, 2), (300, 0.07, 21),
    (100, 0.2899999, 28),
])
def test_capacity_floor_rational_alpha_parity(k, alpha, want):
    """⌊α·k⌋ with the float-dust snap, and every selection path of both
    packages agreeing on the selected set."""
    from repro.kernels.budget_route.ops import capacity_floor as j_cap

    assert tops.capacity_floor(alpha, k) == want == j_cap(alpha, k)
    rng = np.random.RandomState(k)
    scores = (np.abs(rng.randn(k)) + 1.0).astype(np.float32)
    plan = tsched.plan_batch(scores, alpha)
    assert plan.expensive_idx.size == want
    mask, _ = tsched.budget_topk(torch.from_numpy(scores), alpha)
    assert int(mask.sum()) == want
    outs = _route_all(scores, rng.randn(k, 4).astype(np.float32), alpha,
                      kernel=False)
    _assert_same(outs)
    assert int(outs[0][2]) == want
    assert _set(outs[0][1]) == set(plan.expensive_idx.tolist())


@pytest.mark.parametrize("seed", range(4))
def test_plan_batch_and_budget_route_parity(seed):
    """Random batches with ties (scores on a coarse grid, signed zeros
    included), several alphas including one whose capacity is 0."""
    rng = np.random.RandomState(seed)
    k = int(rng.randint(1, 120))
    scores = (np.round(rng.randn(k) * 3) / 3).astype(np.float32)
    tokens = rng.randint(0, 1000, (k, 6)).astype(np.int32)
    for alpha in (0.0, 0.05, 0.2, 0.5):
        tp = tsched.plan_batch(scores, alpha)
        jp = jsched.plan_batch(scores, alpha)
        np.testing.assert_array_equal(tp.expensive_idx, jp.expensive_idx)
        np.testing.assert_array_equal(tp.cheap_idx, jp.cheap_idx)
        assert tp.alpha_effective == jp.alpha_effective
        outs = _route_all(scores, tokens, alpha, kernel=alpha == 0.2)
        _assert_same(outs)
        assert _set(outs[0][1]) == set(tp.expensive_idx.tolist())


@pytest.mark.parametrize("seed", range(4))
def test_budget_topk_parity_breaks_ties_by_index(seed):
    rng = np.random.RandomState(seed)
    k = 40
    scores = (np.round(rng.randn(k) * 2) / 2).astype(np.float32)
    for alpha in (0.1, 0.3, 1.0):
        tm, ti = tsched.budget_topk(torch.from_numpy(scores), alpha)
        jm, ji = jsched.budget_topk(jnp.asarray(scores), alpha)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    tm, ti = tsched.budget_topk(torch.from_numpy(scores), 0.0)
    assert not tm.any() and ti.numel() == 0


def test_host_helpers_are_copies():
    pools = ["cpu", "cpu", "gpu", "gpu"]
    for node in range(4):
        for dev in ("cpu", "gpu"):
            assert (tsched.reissue_candidates(node, pools, dev, 4, {1})
                    == jsched.reissue_candidates(node, pools, dev, 4, {1}))
    clocks = [3.0, 1.0, 1.0, 2.0]
    assert tsched.least_loaded([0, 1, 2, 3], clocks) \
        == jsched.least_loaded([0, 1, 2, 3], clocks) == 1


def _f32(*vals) -> np.ndarray:
    """float32 scores; the string "-nan" is the negative quiet NaN
    0xFFC00000, "nan" the positive one."""
    bits = {"-nan": 0xFFC00000, "nan": 0x7FC00000}
    return np.array([np.array([bits[v]], np.uint32).view(np.float32)[0]
                     if isinstance(v, str) else v for v in vals], np.float32)


# (scores, alpha, require_positive, the JAX package's idx and count):
# a negative NaN ranks below -inf in lax.top_k's total order; a positive
# one above +inf, where torch.topk ranks both; XLA flushes subnormals to
# zero when it compares, so 0.0 and 1e-38 tie at a tau of 1e-38
ROUTE_PROBES = [
    (_f32("-nan", 1.0, 0.5, 0.2), 0.5, True, [1, 2], 2),
    (_f32("nan", 1.0, 0.5, 0.2), 0.5, True, [1, -1], 1),
    (_f32("nan", 1.0, 0.5, 0.2), 0.25, True, [-1], 0),
    (_f32(0.0, 1e-38, -1.0, -2.0), 0.25, False, [0], 1),
    (_f32(-0.0, 0.0, 1e-39, -1.0), 0.25, False, [0], 1),
]


@pytest.mark.parametrize("scores,alpha,positive,want_idx,want_count",
                         ROUTE_PROBES, ids=["neg_nan", "pos_nan_half",
                                            "pos_nan_quarter", "subnormal",
                                            "signed_zero_subnormal"])
def test_budget_route_nan_and_subnormal_parity(scores, alpha, positive,
                                               want_idx, want_count):
    """The port routes what the JAX op (its oracle and its interpret
    kernel) routes at NaN and subnormal scores."""
    tokens = np.arange(4 * len(scores), dtype=np.int32).reshape(-1, 4)
    t = tops.budget_route(torch.from_numpy(scores),
                          torch.from_numpy(tokens), alpha,
                          require_positive=positive)
    assert t[1].tolist() == want_idx and int(t[2]) == want_count
    for fk in (False, True):
        j = j_route(jnp.asarray(scores), jnp.asarray(tokens), alpha,
                    force_kernel=fk, require_positive=positive)
        _assert_same([tuple(np.asarray(x) for x in t),
                      tuple(np.asarray(x) for x in j)])


# count < capacity: the positive clamp lifts tau above the capacity-th
# score (the first two), or tau is a NaN (positive NaNs rank first in
# lax.top_k's order) and keeps nothing
UNUSED_ROW_PROBES = [
    (_f32(0.5, -1.0, 0.2, 0.0), 1.0, [0, 2, -1, -1], 2),
    (_f32(-0.5, -1.0, -0.2, 3.0, -2.0, 0.0, 1e-38, 0.0), 0.5,
     [3, -1, -1, -1], 1),
    (_f32("nan", "nan", 1.0, 0.5), 0.5, [-1, -1], 0),
]


@pytest.mark.parametrize("scores,alpha,want_idx,want_count",
                         UNUSED_ROW_PROBES, ids=["two_positive",
                                                 "one_positive", "nan_tau"])
def test_budget_route_unused_rows_equal_the_oracle(scores, alpha, want_idx,
                                                    want_count):
    """Where count < capacity, the port's rows past the count are zero and
    its idx slots -1, exactly the JAX oracle's (``budget_route_ref``).
    The JAX Pallas kernel (``budget_route_kernel``) never writes those
    rows, so there they are undefined: in interpret mode they hold
    INT_MIN (-2147483648) for int32 tokens. Its idx, count and kept rows
    agree. The port's CUDA kernel writes those rows itself."""
    tokens = np.arange(1, 4 * len(scores) + 1,
                       dtype=np.int32).reshape(-1, 4)
    t = [np.asarray(x) for x in tops.budget_route(
        torch.from_numpy(scores), torch.from_numpy(tokens), alpha)]
    oracle = [np.asarray(x) for x in j_route(
        jnp.asarray(scores), jnp.asarray(tokens), alpha)]
    assert t[1].tolist() == want_idx and int(t[2]) == want_count
    for mine, theirs in zip(t, oracle):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    assert not t[0][want_count:].any()
    kern = [np.asarray(x) for x in j_route(
        jnp.asarray(scores), jnp.asarray(tokens), alpha, force_kernel=True)]
    np.testing.assert_array_equal(t[1], kern[1])
    assert int(t[2]) == int(kern[2])
    np.testing.assert_array_equal(t[0][:want_count], kern[0][:want_count])


@pytest.mark.parametrize("n,sms", [
    (0, 132), (1, 132), (31, 132), (256, 132), (1023, 132), (1024, 132),
    (1025, 132), (4096, 132), (4097, 132), (65536, 132), (67585, 132),
    (1 << 20, 132), (65536, 8)])
def test_budget_route_launch_plan_covers_every_row(n, sms):
    """The one launch's plan: one block of the fewest whole warps up to
    SINGLE_BLOCK_ROWS rows (a row a thread up to 1024), then a grid of at
    most one block an SM, GRID_THREADS threads of GRID_ROWS rows, with
    the fewest chunks a block; every row has a thread, and no block is
    without rows."""
    blocks, threads, rows, chunks = tops.launch_plan(n, sms)
    assert threads % 32 == 0 and 32 <= threads <= tops.MAX_THREADS
    assert rows in (1, 4) and blocks * threads * rows * chunks >= n
    if n <= tops.SINGLE_BLOCK_ROWS:
        assert blocks == chunks == 1
        assert rows == (1 if n <= tops.MAX_THREADS else 4)
        assert threads == max(32, -(-n // (32 * rows)) * 32)   # fewest warps
        assert tops.scratch_ints(blocks) == 0
    else:
        assert threads == tops.GRID_THREADS and rows == tops.GRID_ROWS
        assert 1 < blocks <= sms
        chunk = threads * rows
        assert (blocks - 1) * chunk * chunks < n                # no idle block
        assert chunks == 1 or sms * chunk * (chunks - 1) < n    # fewest chunks
        assert tops.scratch_ints(blocks) == 2 * blocks


@pytest.mark.parametrize("scores,alpha", [
    (_f32(1e-38, -1.0, -2.0, -3.0), 0.5),
    (_f32(-1e-39, 1e-39, 0.0, 2.0), 0.75),
    (_f32("-nan", 1.0, 0.5, 0.2), 0.5),
    (_f32("nan", 1e-38, 0.5, 0.2), 0.5),
], ids=["subnormal", "signed_subnormals", "neg_nan", "pos_nan"])
def test_budget_topk_flushes_subnormals_like_xla(scores, alpha):
    tm, ti = tsched.budget_topk(torch.from_numpy(scores), alpha)
    jm, ji = jsched.budget_topk(jnp.asarray(scores), alpha)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    if scores[0] == np.float32(1e-38):
        assert not tm.any()         # 1e-38 flushes to 0, not > 0


def test_order_helpers():
    """total_order_key sorts as lax.top_k does; flush_subnormal zeroes
    exactly the subnormals, keeping their sign."""
    import jax

    from repro_torch.kernels.order import flush_subnormal, total_order_key

    x = _f32("-nan", "nan", -np.inf, np.inf, -0.0, 0.0, 1e-39, -1e-39,
             1.1754944e-38, -1.1754942e-38, 3.0, -3.0, 1e-45)
    order = torch.sort(total_order_key(torch.from_numpy(x)),
                       descending=True, stable=True).indices
    _, jidx = jax.lax.top_k(jnp.asarray(x), len(x))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jidx))
    f = flush_subnormal(torch.from_numpy(x)).numpy()
    sub = (np.abs(x) < np.float32(2.0 ** -126)) & np.isfinite(x)
    assert (f[sub] == 0).all()
    np.testing.assert_array_equal(np.signbit(f), np.signbit(x))
    keep = ~sub
    np.testing.assert_array_equal(f[keep].view(np.uint32),
                                  x[keep].view(np.uint32))
