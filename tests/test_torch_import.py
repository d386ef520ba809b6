"""Import hygiene of the PyTorch port: it needs neither JAX nor the JAX
package, and its CUDA kernels build only when a CUDA tensor first reaches a
kernel wrapper, so every module imports on a machine without ``nvcc``."""

import subprocess
import sys

import pytest

PORT_MODULES = (
    "vettore_tpu_torch",
    "vettore_tpu_torch._build",
    "vettore_tpu_torch.collection",
    "vettore_tpu_torch.compat",
    "vettore_tpu_torch.convert",
    "vettore_tpu_torch.distance",
    "vettore_tpu_torch.index.flat",
    "vettore_tpu_torch.index.hnsw",
    "vettore_tpu_torch.index.hnsw_build",
    "vettore_tpu_torch.index.hnsw_device",
    "vettore_tpu_torch.index.hnsw_knn_build",
    "vettore_tpu_torch.index.ivf",
    "vettore_tpu_torch.multi_vector",
    "vettore_tpu_torch.muvera",
    "vettore_tpu_torch.observability",
    "vettore_tpu_torch.ops.distance",
    "vettore_tpu_torch.ops.flat_scan",
    "vettore_tpu_torch.ops.ivf",
    "vettore_tpu_torch.ops.maxsim",
    "vettore_tpu_torch.ops.mmr",
    "vettore_tpu_torch.ops.muvera",
    "vettore_tpu_torch.ops.muvera_fde",
    "vettore_tpu_torch.ops.packing",
    "vettore_tpu_torch.ops.pipeline",
    "vettore_tpu_torch.ops.scan_host",
    "vettore_tpu_torch.ops.select",
    "vettore_tpu_torch.ops.topk",
    "vettore_tpu_torch.ops.transport",
    "vettore_tpu_torch.parallel",
    "vettore_tpu_torch.parallel.adaptive_mesh",
    "vettore_tpu_torch.parallel.collection_mesh",
    "vettore_tpu_torch.parallel.cost",
    "vettore_tpu_torch.parallel.hnsw_mesh",
    "vettore_tpu_torch.parallel.ivf_mesh",
    "vettore_tpu_torch.parallel.mesh",
    "vettore_tpu_torch.store.columnar",
    "vettore_tpu_torch.store.snapshot",
    "vettore_tpu_torch.synth",
)


def _run(code: str) -> str:
    # a fresh interpreter: this test process has JAX loaded already
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_module_imports_without_jax(module):
    out = _run(
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'vettore_tpu')))\n")
    assert out.strip() == "[]"


def test_import_builds_nothing():
    out = _run(
        "import vettore_tpu_torch, vettore_tpu_torch.ops.flat_scan as fs\n"
        "import vettore_tpu_torch.ops.maxsim as ms\n"
        "from vettore_tpu_torch import _build\n"
        "print(_build._lib is None, _build.build_dir().name,\n"
        "      sum(fs.LAUNCHES.values()) + sum(ms.LAUNCHES.values()))\n")
    lib_unloaded, digest, launches = out.split()
    assert lib_unloaded == "True" and len(digest) == 16 and launches == "0"
