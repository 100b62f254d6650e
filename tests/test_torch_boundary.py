"""The port's import boundary, and chip_smoke.py's refusal without a card.

``repro_torch`` imports ``torch``, never ``jax`` and nothing of
``repro`` (not even its JAX-free modules).  A subprocess imports every
module of the port with ``sys.modules["jax"] = None`` (so any JAX import
fails) and lists the loaded module names; a name is the reference
package when it is ``repro`` or starts with ``repro.`` — ``repro_torch``
shares the prefix and must not count.
"""

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

_PROBE = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = sorted(n for n, m in sys.modules.items() if m is not None)
print(json.dumps({"imported": names, "loaded": loaded}))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return env


def test_port_imports_no_jax_and_no_reference():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert {"repro_torch.kernels.topk", "repro_torch.core.evaluator",
            "repro_torch.core.embedding_cache", "repro_torch.core.faults",
            "repro_torch.models.convert", "repro_torch.launch.distributed",
            "repro_torch.configs.trove_base", "repro_torch.core.serving",
            "repro_torch.launch.serve", "repro_torch.core.fair_sharding",
            "repro_torch.core.sharded_search", "repro_torch.core.config",
            "repro_torch.training.fault_tolerance",
            "repro_torch.data.table", "repro_torch.data.views",
            "repro_torch.data.loaders", "repro_torch.core.materialized_qrel",
            "repro_torch.core.datasets",
            "repro_torch.launch.evalsuite", "repro_torch.index",
            "repro_torch.index.kmeans",
            "repro_torch.index.ivf", "repro_torch.models.losses",
            "repro_torch.models.retriever", "repro_torch.training.tree",
            "repro_torch.models.transformer",
            "repro_torch.training.optimizer",
            "repro_torch.training.grad_compression",
            "repro_torch.training.checkpoint",
            "repro_torch.training.trainer",
            "repro_torch.launch.train",
            "repro_torch.configs.base", "repro_torch.configs.lm_arch",
            "repro_torch.configs.qwen2_0_5b",
            "repro_torch.configs.stablelm_3b",
            "repro_torch.configs.gemma_7b",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.llama4_maverick_400b_a17b",
            "repro_torch.configs.gnn_arch",
            "repro_torch.configs.graphsage_reddit",
            "repro_torch.models.gnn", "repro_torch.data.graph",
            "repro_torch.launch.roofline", "repro_torch.launch.memmodel",
            "repro_torch.launch.dryrun", "repro_torch.launch.report",
            "repro_torch.launch.hillclimb", "repro_torch.launch.mesh",
            "repro_torch.sharding", "repro_torch.sharding.partitioning",
            "repro_torch.sharding.collectives",
            "repro_torch.sharding.layout"} <= set(
                out["imported"])
    leaked = [m for m in out["loaded"]
              if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
    assert leaked == []


_DATA_PROBE = """
import json, sys
import repro_torch.data.views, repro_torch.core.materialized_qrel
print(json.dumps(sorted(n for n in sys.modules
                        if n == "torch" or n.startswith("torch."))))
"""


def test_data_modules_load_no_torch():
    """The view algebra and MaterializedQRel import no torch module, so a
    process that only loads and streams data (the memory measurement of
    ``chip_smoke.py``) carries no torch in its resident floor."""
    proc = subprocess.run([sys.executable, "-c", _DATA_PROBE], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    """No CUDA device here: chip_smoke.py exits non-zero and prints no
    result line; alone in a directory it fails the same way."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd in (REPO, str(alone)):
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                              env=_env(), capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
