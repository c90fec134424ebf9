"""Guards of the port's boundaries: food101_sr_tpu_torch and chip_smoke.py
import nothing of JAX, PIL or the JAX package; kernel wrappers never fall
back from a device they have no kernel for; entry points default to CUDA
and fail there without a card instead of moving to the CPU."""
import ast
import inspect
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import food101_sr_tpu_torch
from food101_sr_tpu_torch import _build
from food101_sr_tpu_torch.metrics import MetricsCalculator
from food101_sr_tpu_torch.models import build_model, get_model
from food101_sr_tpu_torch.ops import (blur_kernel, mean_kernel,
                                      mean_nhwc_kernel, mean_plane_kernel)
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "yaml",
             "food101_sr_tpu")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        food101_sr_tpu_torch.__path__, "food101_sr_tpu_torch."))


def test_port_imports_no_jax_pil_or_jax_package():
    mods = _all_modules()
    assert "food101_sr_tpu_torch.serving" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", ["chip_smoke.py", "tools/port_serve_profile.py",
                                  "tools/port_wrapper_host.py",
                                  "food101_sr_tpu_torch"])
def test_sources_import_nothing_forbidden(path):
    files = ([ROOT / path] if path.endswith(".py")
             else sorted((ROOT / path).rglob("*.py")))
    for f in files:
        assert not _imported_roots(f) & set(FORBIDDEN), f


# mean_kernel dispatches by layout to two counted entry points
@pytest.mark.parametrize("wrapper,counted", [
    pytest.param(blur_kernel, [blur_kernel], id="blur_kernel"),
    pytest.param(mean_kernel, [mean_nhwc_kernel, mean_plane_kernel],
                 id="mean_kernel")])
def test_wrappers_raise_on_a_device_without_a_kernel(wrapper, counted):
    x = torch.empty(1, 3, 8, 8, device="meta")
    for layout in (torch.contiguous_format, torch.channels_last):
        with pytest.raises(ValueError, match="no kernel"):
            wrapper(x.to(memory_format=layout))
    assert all(w.launches == 0 for w in counted)


@pytest.mark.parametrize("entry", [get_model, build_model, SRServer,
                                   MetricsCalculator])
def test_entry_points_default_to_cuda(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: get_model("AttentionSR"), SRServer,
                 MetricsCalculator):
        with pytest.raises((RuntimeError, AssertionError)):
            make()


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.kernels()


def test_build_flags_target_hopper_without_torch_headers():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for src in (ROOT / "food101_sr_tpu_torch" / "csrc").glob("*.cu"):
        text = src.read_text()
        assert "torch/extension.h" not in text and "extern \"C\"" in text


def test_wrappers_check_inputs_on_the_cpu_as_on_cuda():
    """The checks run before the device dispatch, so a CPU test catches an
    input the CUDA kernel would refuse: for K1 (NCHW planes) channels-last,
    for K2 (NCHW or channels-last) a non-dense view; float64 for both."""
    x = torch.rand(2, 3, 8, 8)
    refused = {blur_kernel: x.to(memory_format=torch.channels_last),
               mean_kernel: x[:, :, ::2]}
    for wrapper, bad in refused.items():
        with pytest.raises(ValueError, match="contiguous"):
            wrapper(bad)
        with pytest.raises(ValueError):
            wrapper(torch.rand(2, 3, 8, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="taps"):
        blur_kernel(torch.rand(1, 1, 8, 8), size=7)
