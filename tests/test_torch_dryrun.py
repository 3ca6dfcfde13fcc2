"""``launch/dryrun.py`` and ``launch/roofline.py`` against the JAX
package's: ``model_flops_for`` of all 42 cells, the argument bytes a
device on both production meshes (the sum of the reference's shard
shapes times item size), the ``Roofline`` formulas, the dry run of one
cell of each family on both meshes and on a 1x1 mesh (the whole
``--both`` sweep takes about 2.5 min on 8 CPU cores, beyond this file's
budget: ``PERF.md`` holds its table), the records' keys, and the kernel
wrappers' meta branches (the kernels' output shapes, their work charged,
no launch counted). Importing ``dryrun`` starts no process group."""
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_mesh_common import (CELLS_SCRIPT, SRC,  # noqa: F401
                               fake_world_512, run_jax_child)

from repro_torch.launch import roofline as rl
from repro_torch.launch.specs import all_cells

CELLS = all_cells()
# one cell of each family, the LM's through the layer extrapolation
FAMILY_CELLS = [("qwen3-1.7b", "train_4k"), ("dlrm-mlperf", "serve_p99"),
                ("equiformer-v2", "molecule"), ("adaparse-router", "dpo_2k"),
                ("nougat-base", "parse_decode"), ("dien", "serve_p99")]
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "flops", "hbm_bytes", "coll_bytes",
    "per_device_mem", "model_flops", "hbm_bytes_fused", "t_compute",
    "t_memory", "t_memory_raw", "t_collective", "bottleneck",
    "roofline_fraction", "flops_efficiency", "compile_s", "prod_compile_s",
    "fits_hbm", "mem_gb", "scan_corrected"}


@pytest.fixture(scope="module")
def reference():
    return run_jax_child(CELLS_SCRIPT)


@pytest.mark.parametrize("arch, shape", CELLS)
def test_model_flops_equal_reference(reference, arch, shape):
    assert rl.model_flops_for(arch, shape) == \
        reference[f"{arch}/{shape}/0"]["model_flops"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch, shape", CELLS)
def test_arg_bytes_per_device_equal_reference(
        fake_world_512, reference, arch, shape, multi_pod):  # noqa: F811
    from repro_torch.distributed.meshrules import AxisRules
    from repro_torch.launch.dryrun import arg_bytes_per_device
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell

    rules = AxisRules(make_production_mesh(multi_pod=multi_pod))
    cell = build_cell(arch, shape, rules=rules, abstract=True)
    assert arg_bytes_per_device(cell) == \
        reference[f"{arch}/{shape}/{int(multi_pod)}"]["arg_bytes"]


def test_roofline_formulas():
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16

    r = rl.Roofline("a", "s", "16x16", 256, flops=1e12, hbm_bytes=8e9,
                    coll_bytes=None, per_device_mem=10, model_flops=3e14,
                    hbm_bytes_fused=5e9)
    assert r.t_compute == 1e12 / PEAK_FLOPS_BF16
    assert r.t_memory == 5e9 / HBM_BW and r.t_memory_raw == 8e9 / HBM_BW
    assert r.t_collective is None
    assert r.bottleneck == "memory"
    assert r.roofline_fraction == pytest.approx(
        3e14 / (256 * PEAK_FLOPS_BF16) / max(r.t_compute, r.t_memory))
    assert r.flops_efficiency == pytest.approx(3e14 / (1e12 * 256))
    d = r.to_dict()
    assert set(d) == REFERENCE_KEYS - {"compile_s", "prod_compile_s",
                                       "fits_hbm", "mem_gb",
                                       "scan_corrected"}
    assert d["coll_bytes"] is None and d["t_collective"] is None
    # with no fused count the raw bytes stand in; collectives can dominate
    c = rl.Roofline("a", "s", "1x1", 1, flops=1e12, hbm_bytes=1e9,
                    coll_bytes={"all-reduce": 9e9}, per_device_mem=0)
    assert c.t_memory == c.t_memory_raw and c.bottleneck == "collective"
    assert rl.Roofline("a", "s", "1x1", 1, flops=None, hbm_bytes=None,
                       coll_bytes=None, per_device_mem=0).bottleneck is None
    assert "| a | s |" in rl.summarize([d])
    # each dtype's FLOPs at its own datasheet peak: float32 outside the
    # tensor cores at 67 TFLOP/s
    from repro_torch.launch.mesh import PEAK_FLOPS_F32

    m = rl.Roofline("a", "s", "1x1", 1, flops=3e12, hbm_bytes=1e9,
                    coll_bytes=None, per_device_mem=0,
                    flops_by_dtype={"bfloat16": 2e12, "float32": 1e12})
    assert m.t_compute == pytest.approx(2e12 / PEAK_FLOPS_BF16
                                        + 1e12 / PEAK_FLOPS_F32)
    assert PEAK_FLOPS_F32 == 67e12 and set(m.to_dict()) == set(d)


def test_op_counter_counts_flops_bytes_and_peak():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    counter = rl.OpCounter(resident=(a, b))
    with counter:
        c = a @ b                    # 2 * 64 * 32 * 16 FLOPs
        d = torch.relu(c)
        del c
        e = d.sum()
    assert counter.flops == 2 * 64 * 32 * 16
    assert counter.flops_by_dtype == {"float32": 2 * 64 * 32 * 16}
    mm = 4 * (64 * 32 + 32 * 16 + 64 * 16)
    relu = 2 * 4 * 64 * 16
    summ = 4 * 64 * 16 + 4
    assert counter.hbm_bytes == mm + relu + summ
    assert counter.hbm_bytes_fused == mm + summ
    assert counter.peak_bytes == 2 * 4 * 64 * 16     # c and d live at once
    assert e.shape == ()


def test_op_counter_books_flops_by_dtype():
    """A bf16 product and a float32 one land under their own dtypes, and
    a kernel's charge under the dtype it names."""
    from repro_torch.kernels import meta as meta_lib

    a = torch.empty(8, 4, dtype=torch.bfloat16, device="meta")
    b = torch.empty(4, 2, dtype=torch.bfloat16, device="meta")
    counter = rl.OpCounter(resident=(a, b))
    with meta_lib.charges(counter.charge), counter:
        a @ b
        a.float() @ b.float()
        meta_lib.charge("k", 10, 7, torch.bfloat16)
    assert counter.flops_by_dtype == {"bfloat16": 2 * 8 * 4 * 2 + 10,
                                      "float32": 2 * 8 * 4 * 2}
    assert counter.flops == sum(counter.flops_by_dtype.values())
    assert counter.kernels == {"k": {"calls": 1, "flops": 10.0,
                                     "bytes": 7.0}}


def test_extrapolated_peak_splits_prefix_layers_suffix():
    """Traces P B S (one layer) and P B B S (two): the last layer block
    and the suffix are extrapolated op by op, so a peak that moves from
    a layer's temporaries (slope 1 a layer) to the suffix (slope 2) at
    depth is found; traces that do not split give None."""
    from repro_torch.launch.dryrun import extrapolated_peak

    pre = [("embed", 10)]
    block = lambda base: [("mm", base + 50), ("add", base + 5)]  # noqa
    t1 = pre + block(10) + [("stack", 10 + 5 + 2 * 5), ("out", 12)]
    t2 = (pre + block(10) + block(15)
          + [("stack", 10 + 10 + 2 * 10), ("out", 14)])
    # depth L: the last block peaks at 10 + 5 (L - 1) + 50, the stack at
    # 10 + 5 L + 10 L
    for L in (1, 2, 3, 8, 28):
        want = max(10, 10 + 5 * (L - 1) + 50, 10 + 15 * L)
        assert extrapolated_peak(t1, t2, L) == want
    assert extrapolated_peak(t1, t1, 3) is None
    assert extrapolated_peak(t1, t2[:-1] + [("other", 1)], 3) is None


@pytest.mark.parametrize("arch, shape, dims", [
    ("qwen3-1.7b", "prefill_32k", {"seq_len": 1024, "global_batch": 2}),
    ("olmoe-1b-7b", "decode_32k", {"seq_len": 2048, "global_batch": 4})])
def test_layer_extrapolation_equals_the_whole_model(arch, shape, dims):
    """An LM's costs from its one- and two-layer runs equal the whole
    model's meta run: FLOPs and bytes exactly, the live peak within
    0.5% (the prefill's peak is the last stack of the layers' caches,
    which no one-layer peak shows)."""
    import dataclasses

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_cell_for, cell_shape

    a, sh = cell_shape(arch, shape)
    sh = ShapeConfig(sh.name, sh.kind, {**sh.dims, **dims})
    if shape.startswith("prefill"):
        a = dataclasses.replace(a, model=dataclasses.replace(
            a.model, attention_impl="pallas"))
    whole = dryrun.meta_costs(build_cell_for(a, sh, None, True))
    ex = dryrun.step_costs(a, sh)
    assert ex["scan_corrected"]
    for k in ("flops", "hbm_bytes", "hbm_bytes_fused"):
        assert ex[k] == pytest.approx(whole[k], rel=1e-12)
    assert ex["temp_bytes"] == pytest.approx(whole["temp_bytes"], rel=5e-3)
    assert {k: v["calls"] for k, v in ex["kernels"].items()} == \
        {k: v["calls"] for k, v in whole["kernels"].items()}


def _dryrun_main(tmp_path, arch, shape, *extra):
    from repro_torch.launch import dryrun

    out = tmp_path / "out"
    rc = dryrun.main(["--arch", arch, "--shape", shape, "--out", str(out),
                      *extra])
    return rc, {p.name: json.loads(p.read_text())
                for p in sorted(out.glob("*.json"))}


@pytest.mark.parametrize("arch, shape", FAMILY_CELLS)
def test_dryrun_both_meshes(tmp_path, capsys, arch, shape):
    import torch.distributed as dist

    was = dist.is_initialized()
    rc, recs = _dryrun_main(tmp_path, arch, shape, "--both")
    out = capsys.readouterr().out
    assert rc == 0 and "FAIL" not in out and "0 failures" in out
    assert sorted(recs) == [f"{arch}__{shape}__pod1.json",
                            f"{arch}__{shape}__pod2.json"]
    forward = shape not in ("train_4k", "molecule", "dpo_2k")
    for name, rec in recs.items():
        assert REFERENCE_KEYS <= set(rec)
        # a forward cell's collectives on the mesh; a train or GNN cell
        # has none counted yet: None, never 0
        if forward:
            assert set(rec["coll_bytes"]) == set(rl.COLL_KINDS)
            assert sum(rec["coll_bytes"].values()) > 0
            assert rec["t_collective"] == pytest.approx(
                sum(rec["coll_bytes"].values()) / 450e9)
        else:
            assert rec["coll_bytes"] is None and rec["t_collective"] is None
        assert rec["chips"] == (512 if "pod2" in name else 256)
        assert rec["flops"] > 0 and rec["t_compute"] > 0
        assert rec["t_memory"] > 0 and rec["temp_bytes"] > 0
        assert rec["bottleneck"] in (("compute", "memory", "collective")
                                     if forward else ("compute", "memory"))
        assert rec["per_device_mem"] == rec["arg_bytes"] + rec["temp_bytes"]
        assert rec["fits_hbm"] == (rec["per_device_mem"] <= 80e9)
        assert rec["scan_corrected"] == (arch == "qwen3-1.7b")
        assert (32 if "pod2" in name else 16) % rec["batch_shards"] == 0
    # the same meta run read on both meshes: global counts over chips
    a, b = (recs[f"{arch}__{shape}__pod{i}.json"] for i in (1, 2))
    assert a["flops"] * 256 == pytest.approx(b["flops"] * 512)
    # main tears down the fake world it started, and only that
    assert dist.is_initialized() == was


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
def test_batch_shards_count_the_data_dims_only(fake_world_512, multi_pod):
    """qwen3 train_4k's tokens are cut over (pod, data) by their batch
    dim and over model by their sequence dim: the temporaries are
    divided by the data-parallel factor alone, 16 or 32, not by every
    chip."""
    from repro_torch.distributed.meshrules import AxisRules
    from repro_torch.launch.dryrun import arg_shards, batch_shards
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import build_cell

    rules = AxisRules(make_production_mesh(multi_pod=multi_pod))
    cell = build_cell("qwen3-1.7b", "train_4k", rules=rules, abstract=True)
    from repro_torch.common import tree_leaves

    n_batch = len(tree_leaves(cell.args[-1]))
    assert any("model" in sh.spec.mesh_dims()
               for _, sh in arg_shards(cell)[-n_batch:])
    assert batch_shards(cell, rules) == (32 if multi_pod else 16)


def test_dryrun_no_costing(tmp_path, capsys):
    rc, recs = _dryrun_main(tmp_path, "deepfm", "train_batch",
                            "--no-costing")
    assert rc == 0
    (rec,) = recs.values()
    assert rec["flops"] is None and rec["temp_bytes"] is None
    assert rec["t_compute"] is None and rec["roofline_fraction"] is None
    assert rec["per_device_mem"] == rec["arg_bytes"]


@pytest.mark.parametrize("arch, shape", FAMILY_CELLS)
def test_run_cell_on_a_1x1_mesh(arch, shape):
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world, make_mesh

    with fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"))
        rec = dryrun.run_cell(arch, shape, mesh=mesh, verbose=False)
    assert rec["mesh"] == "1x1" and rec["chips"] == 1
    assert rec["batch_shards"] == 1
    from repro_torch.launch.specs import build_cell
    from repro_torch.common import tree_bytes
    assert rec["arg_bytes"] == tree_bytes(build_cell(arch, shape).args)
    assert rec["per_device_mem"] == rec["arg_bytes"] + rec["temp_bytes"]
    # one device sends nothing: a forward cell counts zero bytes
    if shape in ("train_4k", "molecule", "dpo_2k"):
        assert rec["coll_bytes"] is None and rec["t_collective"] is None
    else:
        assert rec["coll_bytes"] == {k: 0.0 for k in rl.COLL_KINDS}
        assert rec["t_collective"] == 0.0


# one forward cell of each family that FAMILY_CELLS leaves out
FORWARD_CELLS = [("qwen3-1.7b", "decode_32k"),
                 ("adaparse-router", "route_64k")]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("arch, shape", FORWARD_CELLS)
def test_forward_cells_count_their_collectives(fake_world_512, arch, shape,
                                               multi_pod):  # noqa: F811
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_production_mesh

    rec = dryrun.run_cell(arch, shape, multi_pod, costing=False,
                          mesh=fake_production_mesh(multi_pod=multi_pod),
                          verbose=False)
    assert rec["coll_bytes"] is None          # no costing, no mesh run
    from repro_torch.distributed.meshrules import AxisRules
    from repro_torch.launch.specs import cell_shape

    a, s = cell_shape(arch, shape)
    coll = dryrun.coll_costs(a, s, AxisRules(
        fake_production_mesh(multi_pod=multi_pod)))
    assert set(coll) == set(rl.COLL_KINDS) and sum(coll.values()) > 0
    assert coll["all-gather"] > 0


@pytest.mark.parametrize("arch, shape", [
    ("qwen3-1.7b", "train_4k"), ("equiformer-v2", "molecule"),
    ("dlrm-mlperf", "train_batch"), ("nougat-base", "train_pages"),
    ("adaparse-router", "sft_4k")])
def test_train_and_gnn_cells_count_no_collectives_yet(fake_world_512, arch,
                                                      shape):  # noqa: F811
    from repro_torch.distributed.meshrules import AxisRules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_production_mesh
    from repro_torch.launch.specs import cell_shape

    a, s = cell_shape(arch, shape)
    assert not dryrun.runs_on_mesh(a, s)
    assert dryrun.coll_costs(a, s, AxisRules(fake_production_mesh())) \
        is None


def test_collectives_extrapolate_from_one_and_two_layers(fake_world_512):
    """An LM's collective bytes from its one- and two-layer runs equal a
    three-layer model's own run, kind by kind (the layers are alike, as
    ``extrapolated_peak`` takes them)."""
    import dataclasses

    from repro_torch.distributed.meshrules import AxisRules, use_rules
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_production_mesh
    from repro_torch.launch.specs import build_cell_for, cell_shape, \
        place_args

    rules = AxisRules(fake_production_mesh())
    a, s = cell_shape("qwen3-1.7b", "decode_32k")
    a3 = dataclasses.replace(a, model=dataclasses.replace(a.model,
                                                          n_layers=3))
    ex = dryrun.coll_costs(a3, s, rules)
    cell = build_cell_for(a3, s, rules, True)
    whole = rl.CollCounter()
    with use_rules(rules), whole:
        cell.fn(*place_args(cell))
    assert sum(whole.bytes.values()) > 0
    for k in rl.COLL_KINDS:
        assert ex[k] == pytest.approx(whole.bytes.get(k, 0.0), rel=1e-9,
                                      abs=1e-3)


def test_dryrun_import_starts_no_process_group():
    code = ("import torch.distributed as d\n"
            "import repro_torch.launch.dryrun as D, repro_torch.launch.mesh\n"
            "import repro_torch.distributed.meshrules\n"
            "print(d.is_initialized())\n"
            "import tempfile\n"
            "D.main(['--arch', 'deepfm', '--shape', 'serve_p99', '--out', "
            "tempfile.mkdtemp()])\n"
            "print(d.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == lines[-1] == "False", lines


# --------------------------------------------------------------- meta kernels


def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _c(*shape, dtype=torch.float32, hi=None):
    g = torch.Generator().manual_seed(sum(shape))
    if dtype in (torch.int32, torch.int64):
        return torch.randint(0, hi, shape, generator=g, dtype=dtype)
    return torch.randn(shape, generator=g).to(dtype)


def _meta_like(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


def _calls():
    from repro_torch.kernels.budget_route import ops as br
    from repro_torch.kernels.embedding_bag import ops as eb
    from repro_torch.kernels.fast_features import ops as ff
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ngram_score import ops as ng
    from repro_torch.kernels.segment_mm import ops as sm
    bf = torch.bfloat16
    i32 = torch.int32
    ffkw = dict(max_len=64, ws=2, scramble=3, mangled=4, latex_lo=800,
                ident_lo=850, vocab_size=1000)
    return {
        "fast_features": (lambda *a: ff.fast_features(*a, **ffkw),
                          (_c(4, 128, dtype=i32, hi=1000),
                           *[torch.full((4,), 3, dtype=i32)] * 4)),
        "budget_route": (lambda s, t: br.budget_route(s, t, 0.25),
                         (_c(64), _c(64, 16))),
        "ngram_score": (ng.ngram_bleu,
                        (_c(4, 16, dtype=i32, hi=9), _c(4, 16, dtype=i32,
                                                        hi=9),
                         torch.full((4,), 16, dtype=i32),
                         torch.full((4,), 12, dtype=i32))),
        "flash_attention": (fa.flash_attention,
                            (_c(2, 64, 4, 32, dtype=bf),
                             _c(2, 64, 2, 32, dtype=bf),
                             _c(2, 64, 2, 32, dtype=bf))),
        "embedding_bag": (eb.embedding_bag,
                          (_c(100, 16, dtype=bf), _c(8, 3, dtype=i32,
                                                     hi=100))),
        "embedding_bag_backward": (lambda g, i: eb.embedding_bag_backward(
            g, i, 100), (_c(20, 16), _c(20, dtype=torch.int64, hi=100))),
        "segment_mm": (lambda x, s, d, w: sm.segment_matmul(
            x, s, d, w, n_nodes=10), (_c(10, 8), _c(30, dtype=i32, hi=10),
                                      _c(30, dtype=i32, hi=10),
                                      _c(8, 4))),
    }


@pytest.mark.parametrize("name", list(_calls()))
def test_kernel_wrapper_meta_branch(name):
    """The meta call gives the kernel's output shapes (the plain
    version's shapes; ngram_score's kernel writes float32 where the
    plain version gives float64), charges its work once and counts no
    launch."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels import meta as meta_lib

    fn, args = _calls()[name]
    want = fn(*args)
    before = cuda_lib.launch_counts()
    charged = []
    with meta_lib.charges(lambda *c: charged.append(c)):
        got = fn(*[_meta_like(a) for a in args])
    assert cuda_lib.launch_counts() == before
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.is_meta and g.shape == w.shape
        assert g.dtype == (torch.float32 if name == "ngram_score"
                           else w.dtype)
    assert [c[0] for c in charged] == [name]
    assert charged[0][2] > 0 and isinstance(charged[0][3], torch.dtype)
