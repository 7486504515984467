"""The port stands alone: no JAX, no reference import, no silent fallback
to the CPU."""
import ast
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels import exchange as kx

ROOT = Path(__file__).resolve().parents[1]


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "chip_shapes.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _banned(node.module):
            bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_default_device_means_the_card():
    if torch.cuda.is_available():
        assert repro_torch.default_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.default_device()


def test_default_device_passes_cpu_through():
    assert repro_torch.default_device("cpu") == torch.device("cpu")


def test_wrappers_reject_devices_they_cannot_serve():
    """A mix of devices raises; all-``meta`` inputs (an abstract run) get
    an empty output of the right shape and launch nothing; nothing falls
    back to the plain version."""
    x = torch.empty((1, 4096), device="meta")
    s = torch.empty((4096,), device="meta")
    kx.reset_launches()
    out = kx.fused_rotate(x, s)
    assert out.device.type == "meta" and out.shape == x.shape
    with pytest.raises(ValueError, match="meta tensors only together"):
        kx.fused_rotate(torch.zeros((1, 4096)), s)
    assert sum(kx.LAUNCHES.values()) == 0


def test_cpu_path_launches_nothing():
    kx.reset_launches()
    x = torch.randn((2, 4096))
    s = torch.ones(4096)
    kx.fused_rotate(x, s)
    kx.snap_codes(torch.zeros((2, 4096), dtype=torch.int32), x,
                  torch.ones(2))
    assert kx.LAUNCHES == {k: 0 for k in kx.LAUNCHES}
