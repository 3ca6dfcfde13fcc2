"""Shared helpers of the mesh-layer tests (``test_torch_meshrules.py``,
``test_torch_cells_shardings.py``, ``test_torch_dryrun.py``).

The JAX side of anything that needs a mesh runs in a child interpreter
with 512 host devices (``XLA_FLAGS=--xla_force_host_platform_device_count
=512``, ``JAX_PLATFORMS=cpu``), which must be set before JAX starts, and
passes its results back as JSON. The port's side takes its production
meshes on torch's fake backend in the test process, inside the
``fake_world_512`` fixture, which destroys the process group after the
module.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

SRC = str(Path(__file__).resolve().parents[1] / "src")

# per cell and mesh: every in_shardings leaf (key path, spec), the
# donated arguments, the argument bytes a device (each argument's shard
# shape times its item size) and the cell's model FLOPs
CELLS_SCRIPT = """
import jax
from jax.sharding import NamedSharding
from repro.distributed.meshrules import AxisRules
from repro.launch.mesh import make_production_mesh
from repro.launch.roofline import model_flops_for
from repro.launch.specs import all_cells, build_cell

def spec(s):
    return [e if e is None or isinstance(e, str) else list(e)
            for e in s.spec]

is_sh = lambda x: isinstance(x, NamedSharding)
out = {}
for mp in (False, True):
    rules = AxisRules(make_production_mesh(multi_pod=mp))
    for a, s in all_cells():
        c = build_cell(a, s, rules=rules, abstract=True)
        leaves = jax.tree_util.tree_flatten_with_path(
            c.in_shardings, is_leaf=is_sh)[0]
        shs = [l for _, l in leaves]
        args = jax.tree_util.tree_leaves(c.args)
        assert len(args) == len(shs), (a, s)
        nbytes = sum(int(np.prod(sh.shard_shape(x.shape)))
                     * np.dtype(x.dtype).itemsize
                     for x, sh in zip(args, shs))
        out[f"{a}/{s}/{int(mp)}"] = {
            "leaves": [[jax.tree_util.keystr(p), spec(l)]
                       for p, l in leaves],
            "donate": list(c.donate_argnums), "arg_bytes": int(nbytes),
            "model_flops": float(model_flops_for(a, s))}
"""


def _jax_env(devices: int) -> dict:
    return dict(os.environ,
                XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
                JAX_PLATFORMS="cpu",
                PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))


def run_jax_child(body: str, timeout: float = 300.0, devices: int = 512):
    """Run ``body`` (which fills ``out``) in a child interpreter with
    ``devices`` host devices; returns ``out`` read back from JSON."""
    script = ("import json, sys\nimport numpy as np\n"
              + textwrap.dedent(body)
              + "\njson.dump(out, sys.stdout)\n")
    proc = subprocess.run([sys.executable, "-c", script],
                          env=_jax_env(devices), capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def start_jax_child(body: str, devices: int = 4, inputs=None):
    """Start ``body`` (which reads ``INPUTS`` and fills ``out`` with
    numpy leaves) in a child interpreter with ``devices`` host devices;
    ``finish_jax_child`` of the handle returns ``out``. Both cross as
    pickles; the child runs beside whatever the caller does next."""
    import pickle
    import tempfile

    path = tempfile.mkstemp(suffix=".pkl")[1]
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    script = ("import pickle, sys\nimport numpy as np\n"
              + f"INPUTS = pickle.load(open({path!r}, 'rb'))\n"
              + textwrap.dedent(body)
              + f"\npickle.dump(out, open({path!r}, 'wb'))\n")
    proc = subprocess.Popen([sys.executable, "-c", script],
                            env=_jax_env(devices), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, path


def finish_jax_child(handle, timeout: float = 300.0):
    import pickle

    proc, path = handle
    try:
        _, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, err[-3000:]
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        os.unlink(path)


@pytest.fixture(scope="module")
def fake_world_512():
    """A fake-backend process group of 512 for the module's tests."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import fake_world

    assert not dist.is_initialized()
    with fake_world(512):
        yield
    assert not dist.is_initialized()


def spec_json(spec) -> list:
    """A port ``PartitionSpec`` as the JAX child writes one."""
    return [e if e is None or isinstance(e, str) else list(e) for e in spec]


def keystr_leaves(tree, is_leaf, prefix: str = "") -> list[tuple[str, object]]:
    """(``jax.tree_util.keystr``-style path, leaf) pairs in
    ``tree_leaves`` order: ``['key']`` for a dict key, ``[i]`` for a
    list or tuple index, ``.field`` for a named tuple's field."""
    if is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in keystr_leaves(tree[k], is_leaf,
                                        f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f, v in zip(tree._fields, tree)
                for pl in keystr_leaves(v, is_leaf, f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in keystr_leaves(v, is_leaf, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def port_sharding_leaves(cell) -> dict[str, list]:
    """{key path: spec} of a port cell's ``in_shardings``, with the
    optimizer state's per-leaf lists renamed to the params' key paths
    (the reference keeps the state as a tree shaped like the params)."""
    import torch

    from repro_torch.distributed.meshrules import NamedSharding

    is_sh = lambda x: isinstance(x, NamedSharding)  # noqa: E731
    leaves = keystr_leaves(cell.in_shardings, is_sh)
    if cell.kind == "train":
        j = 2 if cell.shape_name.startswith("dpo") else 1
        names = [p for p, _ in keystr_leaves(cell.args[0], torch.is_tensor)]
        renamed = []
        for path, sh in leaves:
            head = f"[{j}]"
            if path.startswith(head):
                rest = path[len(head):]
                slot, tail = rest.split("]", 1)[0] + "]", \
                    rest.split("]", 1)[1]
                idx, tail = tail[1:].split("]", 1)
                path = head + slot + names[int(idx)] + tail
            renamed.append((path, sh))
        leaves = renamed
    return {p: spec_json(sh.spec) for p, sh in leaves}
