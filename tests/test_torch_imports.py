"""The port stands alone: no module of src/repro_torch, no example of
examples/torch, and not chip_smoke.py, imports jax or the JAX package
(repro), and importing the port pulls neither into a fresh interpreter."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
EXAMPLES = REPO / "examples" / "torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    return sorted(PORT.rglob("*.py")) + sorted(EXAMPLES.glob("*.py")) + [REPO / "chip_smoke.py"]


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, node.lineno


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"prng.py", "convert.py", "core/dmtrl.py", "core/estimator.py",
            "kernels/nvcc.py",
            "kernels/sdca/ops.py", "kernels/sdca/sdca_kernel.py",
            "kernels/flash/ops.py", "kernels/flash/ref.py", "kernels/flash/flash_kernel.py",
            "kernels/ssd/ops.py", "kernels/ssd/ref.py", "kernels/ssd/ssd_kernel.py",
            "configs/base.py", "configs/zamba2_2_7b.py",
            "models/common.py", "models/mlp.py", "models/attention.py",
            "models/ssm.py", "models/transformer.py",
            "serve/scheduler.py", "serve/engine.py", "serve/mtl.py", "serve/fleet.py",
            "serve/metrics.py", "serve/__init__.py",
            "obs/__init__.py", "obs/trace.py", "obs/metrics.py", "obs/export.py",
            "core/sigma_view.py", "core/omega.py", "core/omega_regularizers.py",
            "core/engines.py", "core/wire.py", "core/distributed.py",
            "core/transport.py", "core/async_dmtrl.py", "core/gossip.py",
            "core/convergence.py", "core/baselines.py", "core/feature_maps.py",
            "train/__init__.py", "train/mtl_head.py", "train/optimizer.py",
            "train/loop.py", "train/checkpoint.py",
            "launch/__init__.py", "launch/train.py", "launch/mesh.py",
            "models/sharding.py", "launch/input_specs.py", "launch/dryrun.py",
            "launch/dryrun_dmtrl.py", "roofline/__init__.py", "roofline/analysis.py"} <= names
    for cu in ("sdca/csrc/sdca_round.cu", "sdca/csrc/sdca_block.cu",
               "flash/csrc/flash_fwd.cu", "flash/csrc/flash_bwd.cu", "ssd/csrc/ssd_chunk.cu"):
        assert (PORT / "kernels" / cu).exists(), cu


def test_every_jax_example_has_a_port():
    jax_examples = {p.name for p in (REPO / "examples").glob("*.py")}
    assert len(jax_examples) == 7
    assert jax_examples <= {p.name for p in EXAMPLES.glob("*.py")}


@pytest.mark.parametrize("path", _files(), ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [
        (name, line) for name, line in _imported(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert, repro_torch.prng\n"
        "import repro_torch.kernels.sdca, repro_torch.data.synthetic\n"
        "import repro_torch.serve.scheduler, repro_torch.serve.engine\n"
        "import repro_torch.serve.mtl, repro_torch.serve.fleet, repro_torch.obs\n"
        "import repro_torch.kernels.flash, repro_torch.kernels.ssd, repro_torch.models\n"
        "import repro_torch.configs\n"
        "import repro_torch.core.transport, repro_torch.core.gossip, repro_torch.core.wire\n"
        "import repro_torch.core.async_dmtrl, repro_torch.core.distributed\n"
        "import repro_torch.core.convergence, repro_torch.core.baselines\n"
        "import repro_torch.core.feature_maps\n"
        "import repro_torch.train, repro_torch.train.mtl_head\n"
        "import repro_torch.train.loop, repro_torch.train.optimizer\n"
        "import repro_torch.train.checkpoint, repro_torch.launch, repro_torch.launch.train\n"
        "import repro_torch.launch.mesh, repro_torch.models.sharding\n"
        "import repro_torch.launch.input_specs, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.dryrun_dmtrl, repro_torch.roofline.analysis\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
