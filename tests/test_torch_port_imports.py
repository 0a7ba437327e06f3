"""The port stands alone: no module of catgen_torch, and not chip_smoke.py,
imports jax or the catgen package (the machine with the card runs the
port without them)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "catgen"}


def _port_sources():
    return sorted((ROOT / "catgen_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_every_module_imports_with_jax_and_catgen_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['catgen'] = None\n"
        "import importlib, pkgutil, catgen_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    catgen_torch.__path__, 'catgen_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 60


@pytest.mark.parametrize("module", [
    "catgen_torch.kernels.config", "catgen_torch.kernels.fused_upsample_conv",
    "catgen_torch.kernels.upsample_conv", "catgen_torch.nn.fused",
    "catgen_torch.kernels.st_conv", "catgen_torch.kernels.bilinear_grid",
    "catgen_torch.nn.spatial_transformer"])
def test_kernel_route_modules_import_alone(module):
    """The kernel routes' modules (upsample-conv, ST-conv, grid sampler),
    each in a fresh process with jax and catgen blocked, build nothing at
    import (no nvcc here)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['catgen'] = None\n"
        f"import {module}\n"
        "from catgen_torch.kernels import build\n"
        "assert not build.load_library.cache_info().currsize\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "catgen_torch.train.synthetic", "catgen_torch.train.v_trainer",
    "catgen_torch.train.pretrainer", "catgen_torch.cli.train_v",
    "catgen_torch.cli.pretrain_g"])
def test_v_and_pretrain_modules_import_alone(module):
    """The V subsystem's and the pretrainer's modules, each in a fresh
    process with jax and catgen blocked, build no kernel at import (the
    warp generator reaches the grid sampler's only when it runs)."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['catgen'] = None\n"
        f"import {module}\n"
        "from catgen_torch.kernels import build\n"
        "assert not build.load_library.cache_info().currsize\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "catgen_torch.nn", "catgen_torch.models", "catgen_torch.eval.quality",
    "catgen_torch.cli.eval_quality", "catgen_torch.cli.show_ckpt"])
def test_zoo_and_quality_modules_import_alone(module):
    """The layers' package, the model zoo and the quality evaluation, each
    in a fresh process with jax and catgen blocked, build no kernel at
    import."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['catgen'] = None\n"
        f"import {module}\n"
        "from catgen_torch.kernels import build\n"
        "assert not build.load_library.cache_info().currsize\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", [
    "catgen_torch.dist.mesh", "catgen_torch.dist.dp",
    "catgen_torch.dist.launch", "catgen_torch.data.native_decode"])
def test_dist_and_loader_modules_import_alone(module):
    """Data parallelism's modules and the native decoder's binding, each in
    a fresh process with jax and catgen blocked, start no process group
    and build neither the kernels nor the decoder at import."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['catgen'] = None\n"
        f"import {module}\n"
        "import torch.distributed as dist\n"
        "from catgen_torch.data import native_decode\n"
        "from catgen_torch.kernels import build\n"
        "assert not build.load_library.cache_info().currsize\n"
        "assert not native_decode.load.cache_info().currsize\n"
        "assert not dist.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_no_source_names_jax_or_catgen():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                roots = [node.module.split(".")[0]]
            else:
                continue
            bad = FORBIDDEN.intersection(roots)
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} " \
                            f"imports {sorted(bad)}"
