"""The PyTorch port stands alone: importing every ``repro_torch`` module,
the diagnostics in ``scripts/`` and ``chip_smoke.py`` loads no JAX and nothing of the JAX package
``repro`` (whose name ``repro_torch`` shares as a prefix)."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, json, pathlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
scripts = sorted(pathlib.Path(sys.argv[2], "scripts").glob("*.py"))
for path in scripts:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "scripts": [p.stem for p in scripts],
                  "bad": bad}))
"""


def test_port_imports_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT / "src"), str(ROOT)],
        capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    # every module of the slice was imported
    for name in ("repro_torch.core.engine", "repro_torch.launch.serve",
                 "repro_torch.models.encoder",
                 "repro_torch.kernels.fast_features.ops",
                 "repro_torch.kernels.budget_route.ops",
                 "repro_torch.kernels.ngram_score.ops",
                 "repro_torch.models.transformer",
                 "repro_torch.models.attention",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels.embedding_bag.ops",
                 "repro_torch.kernels.segment_mm.ops",
                 "repro_torch.models.recsys.models",
                 "repro_torch.models.recsys.embedding",
                 "repro_torch.models.recsys.interactions",
                 "repro_torch.models.gnn.segment",
                 "repro_torch.launch.specs",
                 "repro_torch.launch.kernel_timing",
                 "repro_torch.kernels.order",
                 "repro_torch.configs.dlrm_mlperf",
                 "repro_torch.core.dpo", "repro_torch.optim.adamw",
                 "repro_torch.optim.base", "repro_torch.core.campaign",
                 "repro_torch.core.workers",
                 "repro_torch.launch.obs_report",
                 "repro_torch.core.specs", "repro_torch.core.shm",
                 "repro_torch.core.fabric",
                 "repro_torch.launch.worker_main",
                 "repro_torch.launch.fabric_worker",
                 "repro_torch.core.scenarios",
                 "repro_torch.kernels.tuning_store",
                 "repro_torch.kernels.autotune_common",
                 "repro_torch.kernels.fast_features.autotune",
                 "repro_torch.kernels.budget_route.autotune",
                 "repro_torch.kernels.ngram_score.autotune",
                 "repro_torch.optim.adafactor",
                 "repro_torch.optim.schedules",
                 "repro_torch.optim.compression",
                 "repro_torch.checkpoint.checkpoint",
                 "repro_torch.distributed.fault",
                 "repro_torch.launch.train",
                 "repro_torch.models.moe",
                 "repro_torch.configs.olmoe_1b_7b",
                 "repro_torch.configs.grok_1_314b",
                 "repro_torch.configs.phi3_medium_14b"):
        assert name in res["modules"]
    assert "join_timeline" in res["scripts"]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory (or on a host with no card) the smoke run
    exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
