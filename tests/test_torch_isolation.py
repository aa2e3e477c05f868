"""The PyTorch port stands alone: `repro_torch`, chip_smoke.py,
tools/sharded_train_ranks.py, tools/products_probe.py and
tools/profiler_drops.py import neither
jax (nor `ml_dtypes`, its bf16 numpy dtype) nor anything of the JAX
reference package `repro`."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "sharded_train_ranks.py",
    REPO / "tools" / "products_probe.py", REPO / "tools" / "profiler_drops.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "ml_dtypes", "repro"), f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.core, repro_torch.graphs\n"
        "import repro_torch.hopper.tc_spmv, repro_torch.hopper.build\n"
        "import repro_torch.hopper.tc_neighbor_max, repro_torch.hopper.launch\n"
        "import repro_torch.hopper.embedding_bag, repro_torch.models.deepfm\n"
        "import repro_torch.configs.deepfm, repro_torch.data.pipeline\n"
        "import repro_torch.dyngraph, repro_torch.serve_mis, repro_torch.obs.metrics\n"
        "import repro_torch.dyngraph.retile, repro_torch.dyngraph.repair\n"
        "import repro_torch.serve_mis.batcher, repro_torch.serve_mis.io\n"
        "import repro_torch.serve_mis.service, repro_torch.serve_mis.__main__\n"
        "import repro_torch.obs.promtext, repro_torch.obs.report\n"
        "import repro_torch.launch.serve_graphs\n"
        "import repro_torch.train, repro_torch.train.checkpoint, repro_torch.train.tree\n"
        "import repro_torch.models.gnn, repro_torch.graphs.sampler, repro_torch.configs\n"
        "import repro_torch.configs.gnn_cells, repro_torch.configs.gin_tu\n"
        "import repro_torch.configs.pna, repro_torch.configs.egnn, repro_torch.configs.mace\n"
        "import repro_torch.models.lm_config, repro_torch.models.attention\n"
        "import repro_torch.models.moe, repro_torch.models.transformer\n"
        "import repro_torch.configs.lm_cells, repro_torch.configs.qwen3_0_6b\n"
        "import repro_torch.configs.qwen15_0_5b, repro_torch.configs.mixtral_8x22b\n"
        "import repro_torch.configs.deepseek_v3_671b, repro_torch.configs.nemotron4_340b\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.dist, repro_torch.dist.graph, repro_torch.dist.collectives\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'ml_dtypes', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
