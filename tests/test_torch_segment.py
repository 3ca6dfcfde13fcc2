"""The port's GNN segment primitives (``repro_torch.models.gnn.segment``)
and its ``segment_matmul`` op against the JAX package on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages. On
CPU tensors ``ops.segment_matmul`` runs the plain version; the CUDA
kernel is held against it in ``tests/test_torch_cuda.py``. Tolerances:
rtol = atol = 1e-5 for the op (the JAX kernel test's bar,
``tests/test_kernels.py``); 2e-6 for the primitives (float32, another
summation order); exact for counts and gathers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_mm.kernel import segment_matmul_kernel as j_kernel
from repro.kernels.segment_mm.ops import segment_matmul as j_segment_matmul
from repro.kernels.segment_mm.ref import segment_matmul_ref as j_ref
from repro.models.gnn import segment as JS
from repro_torch.kernels.segment_mm import ops
from repro_torch.kernels.segment_mm.ref import segment_matmul_ref
from repro_torch.models.gnn import segment as TS
from repro_torch.models.layers import embed_lookup


def _t(a):
    return torch.from_numpy(np.array(a))


def _graph(e, n, seed, lo=0, hi=None):
    """Edges with some nodes left without any (empty segments)."""
    rng = np.random.RandomState(seed)
    hi = n if hi is None else hi
    src = rng.randint(0, n, e).astype(np.int32)
    dst = rng.randint(lo, hi, e).astype(np.int32)
    dst[dst % 5 == 3] = 0                  # nodes 3, 8, ... keep no edge
    return src, dst


# ------------------------------------------------------------- primitives


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("mode", ["fill", "clip"])
def test_embed_lookup_follows_jax_gathers(mode, dtype):
    """The one gather of the port: ``jnp.take`` (NaN or the integer
    minimum out of range) for ``fill``, JAX indexing (clamped) for
    ``clip``; negative ids wrap in both; any trailing dims."""
    table = (np.arange(5 * 2 * 3) - 7).astype(dtype).reshape(5, 2, 3)
    ids = np.array([[0, 4, -1, -5], [5, -6, 9, 2]], np.int32)
    got = embed_lookup(_t(table), _t(ids), mode=mode).numpy()
    jt, ji = jnp.asarray(table), jnp.asarray(ids)
    want = np.asarray(jnp.take(jt, ji, axis=0) if mode == "fill"
                      else jt[ji])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("e,n,d", [(50, 12, 4), (7, 20, 3), (0, 4, 2)])
def test_segment_primitives_match_jax(e, n, d):
    rng = np.random.RandomState(e + n)
    src, dst = _graph(e, n, e + n)
    msgs = rng.randn(e, d).astype(np.float32)
    x = rng.randn(n, d).astype(np.float32)
    checks = [
        (TS.gather_src(_t(x), _t(src)), JS.gather_src(jnp.asarray(x),
                                                      jnp.asarray(src))),
        (TS.scatter_sum(_t(msgs), _t(dst), n),
         JS.scatter_sum(jnp.asarray(msgs), jnp.asarray(dst), n)),
        (TS.scatter_mean(_t(msgs), _t(dst), n),
         JS.scatter_mean(jnp.asarray(msgs), jnp.asarray(dst), n)),
        (TS.scatter_max(_t(msgs), _t(dst), n),
         JS.scatter_max(jnp.asarray(msgs), jnp.asarray(dst), n)),
        (TS.segment_softmax(_t(msgs), _t(dst), n),
         JS.segment_softmax(jnp.asarray(msgs), jnp.asarray(dst), n)),
        (TS.degree(_t(dst), n), JS.degree(jnp.asarray(dst), n)),
    ]
    for i, (got, want) in enumerate(checks):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape, i
        assert str(got.dtype).split(".")[-1] == str(want.dtype), i
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6,
                                   err_msg=str(i))
    if e:
        # an empty segment: sum 0, max -inf (softmax then shifts by 0)
        assert TS.scatter_max(_t(msgs), _t(dst), n)[3].isneginf().all()
        assert bool((TS.scatter_sum(_t(msgs), _t(dst), n)[3] == 0).all())


def test_segment_primitives_out_of_range_ids_match_jax():
    """Segment ids outside [0, n) are dropped by the scatters; gathers
    follow jnp.take (wrap, NaN) and jnp indexing (wrap, clamp)."""
    rng = np.random.RandomState(9)
    n, e = 6, 30
    dst = rng.randint(-3, n + 3, e).astype(np.int32)
    msgs = rng.randn(e, 3).astype(np.float32)
    x = rng.randn(n, 3).astype(np.float32)
    for tf, jf in ((TS.scatter_sum, JS.scatter_sum),
                   (TS.scatter_mean, JS.scatter_mean),
                   (TS.scatter_max, JS.scatter_max),
                   (TS.segment_softmax, JS.segment_softmax)):
        np.testing.assert_allclose(
            tf(_t(msgs), _t(dst), n).numpy(),
            np.asarray(jf(jnp.asarray(msgs), jnp.asarray(dst), n)),
            atol=2e-6, rtol=2e-6, err_msg=tf.__name__)
    np.testing.assert_array_equal(
        TS.gather_src(_t(x), _t(dst)).numpy(),
        np.asarray(JS.gather_src(jnp.asarray(x), jnp.asarray(dst))))
    np.testing.assert_array_equal(
        TS.degree(_t(dst), n).numpy(),
        np.asarray(JS.degree(jnp.asarray(dst), n)))


# ------------------------------------------------------------- the op


# the grid of tests/test_kernels.py::test_segment_mm_sweep
GRID = [(100, 20, 16, 8), (256, 64, 8, 8), (73, 10, 32, 16)]


def _inputs(e, n, din, dout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, din).astype(np.float32)
    w = rng.randn(din, dout).astype(np.float32)
    src = rng.randint(0, n, e).astype(np.int32)
    dst = rng.randint(0, n, e).astype(np.int32)
    return x, src, dst, w


@pytest.mark.parametrize("e,n,din,dout", GRID)
def test_segment_matmul_matches_jax_kernel(e, n, din, dout):
    """The JAX op with its Pallas kernel in interpret mode."""
    x, src, dst, w = _inputs(e, n, din, dout, e)
    want = np.asarray(j_segment_matmul(jnp.asarray(x), jnp.asarray(src),
                                       jnp.asarray(dst), jnp.asarray(w),
                                       n_nodes=n, force_kernel=True))
    got = ops.segment_matmul(_t(x), _t(src), _t(dst), _t(w), n_nodes=n)
    assert got.dtype == torch.float32 and got.shape == (n, dout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the pre-gathered entry point against the JAX kernel on the same
    # sorted edges (int64 dst on the port's side)
    order = np.argsort(dst, kind="stable")
    xg = x[src[order]]
    want_k = np.asarray(j_kernel(jnp.asarray(xg), jnp.asarray(w),
                                 jnp.asarray(dst[order]), n_nodes=n,
                                 block_e=64, interpret=True))
    got_k = ops.segment_matmul_kernel(_t(xg), _t(w), _t(dst[order]).long(),
                                      n_nodes=n)
    np.testing.assert_allclose(got_k.numpy(), want_k, rtol=1e-5, atol=1e-5)


def _sum_then_gemm_order(xg, w, dst, n_nodes, nodes=64, tile_e=64):
    """The CUDA kernel's order of operations in plain PyTorch: a block
    owns ``nodes`` output nodes and walks its slab of edges ``tile_e``
    rows at a time; each node's rows of a tile are summed in edge order,
    each tile's partial is added to the node's running sum, and the
    sums are multiplied by W once per node."""
    xg, dst = torch.from_numpy(xg), torch.from_numpy(dst).long()
    keep = (dst >= 0) & (dst < n_nodes)
    e_idx = torch.arange(dst.shape[0])
    block_start = torch.searchsorted(dst, torch.arange(0, n_nodes, nodes))
    blk = (dst.clamp(0, n_nodes - 1) // nodes)
    tile = (e_idx - block_start[blk]) // tile_e
    key = torch.stack([tile, dst], 1)[keep]
    new_run = torch.ones(key.shape[0], dtype=torch.bool)
    new_run[1:] = (key[1:] != key[:-1]).any(1)
    run_id = torch.cumsum(new_run.long(), 0) - 1
    part = torch.zeros((int(new_run.sum()), xg.shape[1])).index_add_(
        0, run_id, xg[keep])
    sums = torch.zeros((n_nodes, xg.shape[1])).index_add_(
        0, key[new_run, 1], part)
    return (sums @ torch.from_numpy(w)).numpy()


def _skewed_graph(e, n, hub_edges, seed):
    """Uniform edges plus one hub node that receives ``hub_edges`` more,
    sorted by dst."""
    rng = np.random.RandomState(seed)
    dst = np.concatenate([rng.randint(0, n, e), np.full(hub_edges, n // 3)])
    src = rng.randint(0, n, dst.shape[0])
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


@pytest.mark.parametrize("e,n,din,dout,hub", [
    (100, 20, 16, 8, 0), (256, 64, 8, 8, 0), (73, 10, 32, 16, 0),
    (500, 150, 12, 8, 1500),          # degree-skewed: one hub of 1500
])
def test_sum_then_gemm_order_matches_jax_kernel(e, n, din, dout, hub):
    """Node sums before the GEMV, as the CUDA kernel takes them, against
    the JAX Pallas kernel (one GEMV per edge) in interpret mode, at the
    kernel's bar."""
    rng = np.random.RandomState(e + hub)
    x = rng.randn(n, din).astype(np.float32)
    w = rng.randn(din, dout).astype(np.float32)
    src, dst = _skewed_graph(e, n, hub, e)
    xg = x[src]
    want = np.asarray(j_kernel(jnp.asarray(xg), jnp.asarray(w),
                               jnp.asarray(dst), n_nodes=n, block_e=64,
                               interpret=True))
    got = _sum_then_gemm_order(xg, w, dst, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_segment_matmul_drops_out_of_range_dst_like_the_oracle():
    """segment_sum drops dst >= n_nodes (and < 0); the JAX kernel clamps
    such edges onto the last node instead: for dst [2, 2, 2, 3, 3, 3]
    and n_nodes 3, node 2 gets 6.0 from the kernel and 3.0 from the
    oracle."""
    xg = np.ones((6, 1), np.float32)
    w = np.ones((1, 1), np.float32)
    for dst, node2 in (([2, 2, 2, 3, 3, 3], 3.0), ([-1, 0, 2, 2, 2, 5], 3.0)):
        dst = np.array(dst, np.int32)
        want = np.asarray(j_ref(jnp.asarray(xg), jnp.asarray(w),
                                jnp.asarray(dst), n_nodes=3))
        got = ops.segment_matmul_kernel(_t(xg), _t(w), _t(dst), n_nodes=3)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[2, 0] == node2
        np.testing.assert_array_equal(
            segment_matmul_ref(_t(xg), _t(w), _t(dst), n_nodes=3).numpy(),
            want)
    clamp = np.asarray(j_kernel(jnp.asarray(xg), jnp.asarray(w),
                                jnp.asarray([2, 2, 2, 3, 3, 3], jnp.int32),
                                n_nodes=3, interpret=True))
    assert clamp[2, 0] == 6.0


def test_segment_matmul_gathers_like_jnp_take():
    """A source id past the end gives a NaN message row; a negative one
    wraps. Unsorted dst is sorted by the op itself."""
    x, _, _, w = _inputs(8, 5, 3, 2, 1)
    src = np.array([0, 7, -1, 2, 4, 1], np.int32)
    dst = np.array([3, 1, 0, 3, 2, 0], np.int32)
    want = np.asarray(j_segment_matmul(jnp.asarray(x), jnp.asarray(src),
                                       jnp.asarray(dst), jnp.asarray(w),
                                       n_nodes=5))
    got = ops.segment_matmul(_t(x), _t(src), _t(dst), _t(w), n_nodes=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.isnan(got.numpy()[1]).all()


def test_segment_matmul_refuses_what_it_does_not_take():
    xg, w = torch.zeros(4, 3), torch.zeros(3, 2)
    with pytest.raises(ValueError, match="sorted ascending"):
        ops.segment_matmul_kernel(xg, w, torch.tensor([0, 2, 1, 3]),
                                  n_nodes=4)
    with pytest.raises(ValueError, match="int32 or int64"):
        ops.segment_matmul_kernel(xg, w, torch.zeros(4), n_nodes=4)
    with pytest.raises(ValueError, match=r"\(E,\)"):
        ops.segment_matmul_kernel(xg, w, torch.zeros(3, dtype=torch.int64),
                                  n_nodes=4)
    with pytest.raises(ValueError, match="D_in"):
        ops.segment_matmul_kernel(xg, torch.zeros(4, 2),
                                  torch.zeros(4, dtype=torch.int64),
                                  n_nodes=4)
    with pytest.raises(ValueError, match="one device"):
        ops.segment_matmul_kernel(xg, w.to("meta"),
                                  torch.zeros(4, dtype=torch.int64),
                                  n_nodes=4)


def test_column_chunk_fits_shared_memory():
    """The block plan: nodes a block owns (also the ring's rows), and the
    column chunk of W that phase 2 stages in the ring's space."""
    assert ops.block_plan(100, 128) == (64, 64)
    assert ops.block_plan(16, 8) == (64, 8)
    assert ops.block_plan(3, 5) == (64, 8)
    nodes, cw = ops.block_plan(1433, 256)            # full_graph_sm's d_feat
    assert 2 <= nodes < 64
    assert 4 <= cw <= 2 * nodes and cw % 4 == 0
    assert ops.smem_bytes(1433, nodes) <= ops.SMEM_BYTES
    assert ops.smem_bytes(1433, nodes + 1) > ops.SMEM_BYTES
    # the W chunk fits in the ring: d_in x cw floats in 2 x nodes rows
    assert 1433 * cw <= 2 * nodes * 1436
    with pytest.raises(ValueError, match="shared memory"):
        ops.block_plan(60000, 8)
