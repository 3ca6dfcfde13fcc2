"""The port's checkpoints (``repro_torch.checkpoint.checkpoint``): the JAX
package's layout (``.tmp.<step>`` replaced into ``ckpt_<step>``,
``arrays.npz`` and ``meta.json``, retention), with a JSON list of key
paths in place of the pickled tree and bf16 leaves stored as their
bits. Round trips are held bit for bit."""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                   "layers": {"b": torch.randn(5, generator=g),
                              "n": torch.tensor([-1.5, float("nan")],
                                                dtype=torch.bfloat16)}},
        "opt_state": {"m": [torch.randn(2, 2, generator=g),
                            torch.arange(6, dtype=torch.int32)],
                      "v": [{"vr": torch.randn(3, generator=g),
                             "vc": torch.randn(4, generator=g)},
                            {"v": torch.arange(3, dtype=torch.int64)}]},
        "host": np.array([True, False]),
    }


def _same(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x = torch.as_tensor(x)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        if x.is_floating_point():      # NaN bits too
            k = {2: torch.int16, 4: torch.int32}[x.element_size()]
            assert torch.equal(x.view(k), y.view(k)), path
        else:
            assert torch.equal(x, y), path


def test_round_trip_is_bit_exact_and_keeps_the_tree(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 7, tree, metadata={"loss": 1.25})
    assert os.path.basename(path) == "ckpt_0000000007"
    assert sorted(os.listdir(path)) == ["arrays.npz", "meta.json",
                                        "tree.json"]
    spec = json.load(open(os.path.join(path, "tree.json")))
    assert spec["paths"][0] == ["host"] and "bfloat16" in spec["dtypes"]
    i = spec["dtypes"].index("bfloat16")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data[f"leaf_{i}"].dtype == np.uint16         # bf16 bits
    step, got, meta = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 7 and meta == {"step": 7, "loss": 1.25}
    assert set(got) == {"params", "opt_state", "host"}
    assert isinstance(got["opt_state"]["v"], list)
    assert set(got["opt_state"]["v"][0]) == {"vr", "vc"}
    _same(tree, got)


def test_retention_keeps_three_and_leaves_no_tmp(tmp_path):
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, {"x": torch.full((2,), step)})
    assert ckpt.all_steps(str(tmp_path)) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    ckpt.save(str(tmp_path), 5, {"x": torch.full((2,), 50)})  # overwrite
    step, tree, _ = ckpt.restore(str(tmp_path), step=4, device="cpu")
    assert step == 4 and tree["x"].tolist() == [4, 4]
    assert ckpt.restore(str(tmp_path), device="cpu")[1]["x"].tolist() == \
        [50, 50]
    ckpt.save(str(tmp_path), 9, {"x": torch.zeros(1)}, keep=1)
    assert ckpt.all_steps(str(tmp_path)) == [9]


def test_save_async_snapshots_at_once_and_joins(tmp_path):
    """The leaves are copied to the host when ``save_async`` returns: an
    in-place update after it (training's ``apply_updates``) does not
    reach the checkpoint."""
    tree = _tree(1)
    want = ckpt._flatten(_tree(1))
    t = ckpt.save_async(str(tmp_path), 3, tree, metadata={"a": 1})
    tree["params"]["w"].add_(1)
    tree["opt_state"]["m"][0].mul_(0)
    t.join(timeout=60)
    assert not t.is_alive()
    step, got, meta = ckpt.restore(str(tmp_path), device="cpu")
    assert step == 3 and meta["a"] == 1
    _same(ckpt._unflatten([p for p, _ in want], [x for _, x in want]), got)


def test_restore_without_a_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "absent"), device="cpu")
    assert ckpt.all_steps(str(tmp_path / "absent")) == []
    assert ckpt.latest_step(str(tmp_path)) is None


def test_restore_defaults_to_cuda(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="cuda"):     # no card here
        ckpt.restore(str(tmp_path))
