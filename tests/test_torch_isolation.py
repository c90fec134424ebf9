"""Guards of the port's boundaries: food101_sr_tpu_torch and chip_smoke.py
import nothing of JAX, PIL or the JAX package; the port's C++ and CUDA
include no JPEG or WebP library's header and nothing links one; kernel
wrappers never fall back from a device they have no kernel for; entry
points default to CUDA and fail there without a card instead of moving
to the CPU."""
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
from food101_sr_tpu_torch import (_build, bench, export_serving,
                                  generate_model_vis, native, predict, serve,
                                  sweep, visualize)
from food101_sr_tpu_torch.data import (DeviceCacheLoader, DeviceWindowLoader,
                                       HostCanvasLoader, SRDataLoader,
                                       SyntheticSource)
from food101_sr_tpu_torch.losses import PerceptualLoss, get_loss_function
from food101_sr_tpu_torch.metrics import LPIPSAlex, MetricsCalculator
from food101_sr_tpu_torch.models import (build_model, get_model,
                                         model_for_params)
from food101_sr_tpu_torch.ops import (blur_kernel, mean_kernel,
                                      mean_nhwc_kernel, mean_plane_kernel)
from food101_sr_tpu_torch.parallel import make_mesh
from food101_sr_tpu_torch.parallel.distributed import rank_device
from food101_sr_tpu_torch.serving import SRServer
from food101_sr_tpu_torch.training import train

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "yaml",
             "food101_sr_tpu")


# the modules of the training, GAN, generator, serving, phase-tail and
# quantization, cache, export and offline-tool slices, named so the check
# cannot miss them
NEW_MODULES = ("food101_sr_tpu_torch.analyze_models",
               "food101_sr_tpu_torch.bench",
               "food101_sr_tpu_torch.convert",
               "food101_sr_tpu_torch.data.canvas_cache",
               "food101_sr_tpu_torch.data.device_cache",
               "food101_sr_tpu_torch.data.pil_bicubic",
               "food101_sr_tpu_torch.data.pipeline",
               "food101_sr_tpu_torch.data.sources",
               "food101_sr_tpu_torch.export_serving",
               "food101_sr_tpu_torch.generate_model_vis",
               "food101_sr_tpu_torch.losses",
               "food101_sr_tpu_torch.losses.perceptual",
               "food101_sr_tpu_torch.losses.tv",
               "food101_sr_tpu_torch.models.discriminator",
               "food101_sr_tpu_torch.models.feature_nets",
               "food101_sr_tpu_torch.models.layers",
               "food101_sr_tpu_torch.models.registry",
               "food101_sr_tpu_torch.models.resnet_sr",
               "food101_sr_tpu_torch.models.rrdb",
               "food101_sr_tpu_torch.models.srcnn",
               "food101_sr_tpu_torch.native",
               "food101_sr_tpu_torch.native.cielab",
               "food101_sr_tpu_torch.native.jpeg2000",
               "food101_sr_tpu_torch.native.legacy",
               "food101_sr_tpu_torch.native.openers",
               "food101_sr_tpu_torch.ops.pixel_shuffle",
               "food101_sr_tpu_torch.ops.quantize",
               "food101_sr_tpu_torch.ops.subpixel_conv",
               "food101_sr_tpu_torch.ops.tracing",
               "food101_sr_tpu_torch.ops.tta",
               "food101_sr_tpu_torch.parallel.distributed",
               "food101_sr_tpu_torch.parallel.mesh",
               "food101_sr_tpu_torch.parallel.spatial",
               "food101_sr_tpu_torch.parallel.spatial_mesh",
               "food101_sr_tpu_torch.predict",
               "food101_sr_tpu_torch.serve",
               "food101_sr_tpu_torch.sweep",
               "food101_sr_tpu_torch.train",
               "food101_sr_tpu_torch.training.checkpoint",
               "food101_sr_tpu_torch.training.diagnostics",
               "food101_sr_tpu_torch.training.loop",
               "food101_sr_tpu_torch.training.packed",
               "food101_sr_tpu_torch.training.preempt",
               "food101_sr_tpu_torch.training.schedule",
               "food101_sr_tpu_torch.training.state",
               "food101_sr_tpu_torch.training.steps",
               "food101_sr_tpu_torch.utils.logging",
               "food101_sr_tpu_torch.utils.rng",
               "food101_sr_tpu_torch.utils.term_sums",
               "food101_sr_tpu_torch.visualize")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        food101_sr_tpu_torch.__path__, "food101_sr_tpu_torch."))


def test_port_imports_no_jax_pil_or_jax_package():
    mods = _all_modules()
    assert set(NEW_MODULES) | {"food101_sr_tpu_torch.serving"} <= set(mods)
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
                                  "tools/port_loop_contention.py",
                                  "tools/port_winner_costs.py",
                                  "food101_sr_tpu_torch"])
def test_sources_import_nothing_forbidden(path):
    files = ([ROOT / path] if path.endswith(".py")
             else sorted((ROOT / path).rglob("*.py")))
    for f in files:
        assert not _imported_roots(f) & set(FORBIDDEN), f


def test_codecs_use_no_jpeg_library():
    """The JPEG codec is the port's own: no source includes jpeglib.h,
    turbojpeg.h or nvjpeg.h, no build command or script names -ljpeg, and
    the built library depends on no libjpeg."""
    pkg = ROOT / "food101_sr_tpu_torch"
    for src in sorted(pkg.rglob("*.cpp")) + sorted(pkg.rglob("*.cu")) + \
            sorted(pkg.rglob("*.h")):
        includes = [ln for ln in src.read_text().splitlines()
                    if ln.lstrip().startswith("#include")]
        for header in ("jpeglib.h", "turbojpeg.h", "nvjpeg.h"):
            assert not any(header in ln for ln in includes), (src, header)
    for py in sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "-ljpeg" not in py.read_text(), py
    assert native.jpeg_available()
    deps = subprocess.run(["ldd", native._libs["fast_jpeg"]._name],
                          capture_output=True, text=True).stdout
    assert "jpeg" not in deps.replace(native._libs["fast_jpeg"]._name, "")


def test_webp_codec_uses_no_library():
    """The WebP decoder is the port's own: no source includes libwebp's
    headers, no build command or script names -lwebp, and the library
    fast_webp.cpp builds into depends on no libwebp."""
    pkg = ROOT / "food101_sr_tpu_torch"
    for src in sorted(pkg.rglob("*.cpp")) + sorted(pkg.rglob("*.h")):
        assert not any("webp/" in ln for ln in src.read_text().splitlines()
                       if ln.lstrip().startswith("#include")), src
    for py in sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "-lwebp" not in py.read_text(), py
    so = native._webp_lib()._name
    deps = subprocess.run(["ldd", so], capture_output=True, text=True).stdout
    assert "webp" not in deps.replace(so, "")


def test_tiff_codec_uses_no_library():
    """The TIFF decompressors (PackBits, LZW, CCITT) and QOI's ops are the
    port's own: fast_tiff.cpp includes no libtiff header, no build command
    or script names -ltiff, and the library it builds into depends on no
    libtiff (Deflate and LZMA come from Python's stdlib zlib and lzma)."""
    pkg = ROOT / "food101_sr_tpu_torch"
    for src in sorted(pkg.rglob("*.cpp")) + sorted(pkg.rglob("*.h")):
        assert not any("tiff" in ln.lower() for ln in src.read_text()
                       .splitlines() if ln.lstrip().startswith("#include")), src
    for py in sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert "-ltiff" not in py.read_text(), py
    so = native.tiff_lib()._name
    deps = subprocess.run(["ldd", so], capture_output=True, text=True).stdout
    assert "tiff" not in deps.replace(so, "").lower()


def test_zstd_codec_uses_no_library():
    """The ZSTD decoder is the port's own: no source includes zstd's
    headers, no build command or script names -lzstd, no module of the
    port or chip_smoke.py imports the zstandard module (the card's host has
    none), and the library fast_zstd.cpp builds into depends on no
    libzstd."""
    pkg = ROOT / "food101_sr_tpu_torch"
    for src in sorted(pkg.rglob("*.cpp")) + sorted(pkg.rglob("*.h")):
        assert not any("zstd" in ln.lower() for ln in src.read_text()
                       .splitlines() if ln.lstrip().startswith("#include")), src
    for py in sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = py.read_text()
        assert "-lzstd" not in text, py
        assert not any(ln.lstrip().startswith(("import zstandard",
                                               "from zstandard"))
                       for ln in text.splitlines()), py
    from food101_sr_tpu_torch.native import tiff
    so = tiff.zstd_lib()._name
    deps = subprocess.run(["ldd", so], capture_output=True, text=True).stdout
    assert "zstd" not in deps.replace(so, "").lower()


def test_legacy_raster_codec_uses_no_library():
    """The TGA, PCX, SGI, Sun and PhotoCD loops are the port's own:
    fast_legacy.cpp includes only the C++ standard library, its build
    links nothing, and the walk and the legacy decoders import no image
    module (PIL's plugins are read, not called)."""
    src = ROOT / "food101_sr_tpu_torch" / "native" / "fast_legacy.cpp"
    includes = [ln.split()[1] for ln in src.read_text().splitlines()
                if ln.lstrip().startswith("#include")]
    assert includes and all(i.startswith("<c") for i in includes), includes
    from food101_sr_tpu_torch.native import legacy
    so = legacy.legacy_lib()._name
    deps = subprocess.run(["ldd", so], capture_output=True, text=True).stdout
    for lib in ("png", "jpeg", "tiff", "webp", "zstd", "python"):
        assert lib not in deps.replace(so, "").lower(), deps
    for name in ("legacy.py", "openers.py"):
        roots = _imported_roots(src.parent / name)
        assert not roots & set(FORBIDDEN), (name, roots)


def test_jpeg2000_psd_and_lab_use_no_library():
    """JPEG 2000, PSD and Lab are the port's own: fast_j2k.cpp includes
    only the C++ standard library and no OpenJPEG header, its build links
    nothing, no script names -lopenjp2, and jpeg2000.py, cielab.py and
    legacy.py import no image or colour-management module (PIL's plugins
    and LittleCMS are read, not called)."""
    pkg = ROOT / "food101_sr_tpu_torch"
    src = pkg / "native" / "fast_j2k.cpp"
    includes = [ln.split()[1] for ln in src.read_text().splitlines()
                if ln.lstrip().startswith("#include")]
    assert includes and all(i.startswith("<") and "openjpeg" not in i
                            for i in includes), includes
    for py in sorted(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = py.read_text()
        assert "-lopenjp2" not in text and "-llcms" not in text, py
    from food101_sr_tpu_torch.native import jpeg2000
    so = jpeg2000.j2k_lib()._name
    deps = subprocess.run(["ldd", so], capture_output=True, text=True).stdout
    for lib in ("openjp", "lcms", "png", "jpeg", "tiff", "python"):
        assert lib not in deps.replace(so, "").lower(), deps
    for name in ("jpeg2000.py", "cielab.py", "legacy.py"):
        roots = _imported_roots(src.parent / name)
        assert not roots & set(FORBIDDEN), (name, roots)


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


@pytest.mark.parametrize("entry", [get_model, build_model, model_for_params,
                                   SRServer,
                                   MetricsCalculator, LPIPSAlex, train,
                                   SRDataLoader, DeviceCacheLoader,
                                   HostCanvasLoader, DeviceWindowLoader,
                                   PerceptualLoss,
                                   get_loss_function, serve.build_parser,
                                   predict.build_parser, bench.bench_infer,
                                   bench.bench_train, bench.bench_gan,
                                   bench.parse_device,
                                   export_serving.load_bucket,
                                   export_serving.build_parser,
                                   visualize.run_comparison,
                                   visualize.ModelRunner,
                                   generate_model_vis.visualize_all_models,
                                   sweep.run_sweep, sweep.run_asha])
def test_entry_points_default_to_cuda(entry):
    """A function's ``device`` parameter; a CLI's ``--device`` flag (the
    export CLI's ``--cpu``, off by default)."""
    if entry in (serve.build_parser, predict.build_parser):
        assert entry().get_default("device") == "cuda"
    elif entry is export_serving.build_parser:
        assert entry().get_default("cpu") is False
    elif entry is bench.parse_device:
        assert entry(["--train"]) == "cuda"
    else:
        assert inspect.signature(entry).parameters["device"].default == \
            "cuda"


def test_cuda_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / "a.png").write_bytes(native.encode_png_rgb8(
        torch.zeros(8, 8, 3, dtype=torch.uint8).numpy()))
    for make in (lambda: get_model("AttentionSR"), SRServer,
                 lambda: get_model("RRDB"), lambda: SRServer("RESNET"),
                 lambda: model_for_params(
                     get_model("SRCNN", device="cpu").state_dict()),
                 lambda: train({"dataset": "synthetic"}),
                 MetricsCalculator,
                 lambda: train({"dataset": "synthetic",
                                "architecture": "AttentionSR"}),
                 lambda: train({"dataset": "synthetic",
                                "architecture": "AttentionSR",
                                "loss_function": "gan"}),
                 lambda: get_loss_function("perceptual"),
                 lambda: SRServer("SRCNN", tta=True),
                 lambda: SRServer("RESNET", quantize="int8"),
                 lambda: get_model("RRDB", quantize="int8_dot",
                                   phase_tail=True),
                 lambda: train({"dataset": "synthetic",
                                "architecture": "RESNET",
                                "quantize": "qat"}),
                 lambda: train({"dataset": "synthetic", "dtype": "bfloat16"}),
                 lambda: train({"dataset": "synthetic",
                                "cache_device": True}),
                 lambda: train({"dataset": "synthetic",
                                "cache_host": str(tmp_path / "store")}),
                 lambda: DeviceCacheLoader(SyntheticSource(n=4),
                                           crop_size=32, batch_size=2),
                 lambda: next(iter(HostCanvasLoader(
                     SyntheticSource(n=4), crop_size=32, batch_size=2,
                     cache_dir=str(tmp_path / "store")))),
                 lambda: next(iter(DeviceWindowLoader(
                     SyntheticSource(n=4), crop_size=32, batch_size=2,
                     cache_dir=str(tmp_path / "store")))),
                 lambda: serve.main(["--architecture", "SRCNN", "--port",
                                     "0"]),
                 make_mesh, lambda: SRServer("SRCNN", use_mesh=True),
                 lambda: rank_device("cuda"),
                 lambda: train({"dataset": "synthetic",
                                "coordinator": "localhost:1",
                                "num_processes": 1, "process_id": 0}),
                 lambda: predict.main([str(tmp_path), "--out_dir",
                                       str(tmp_path / "out")]),
                 lambda: bench.main([]), lambda: bench.main(["--input"]),
                 lambda: bench.bench_train("SRCNN", batch=1, crop=8),
                 lambda: export_serving.main(["--architecture", "SRCNN",
                                              "--out", str(tmp_path / "aot")]),
                 lambda: visualize.main(["--dataset", "synthetic",
                                         "--num_examples", "1", "--out_dir",
                                         str(tmp_path / "rep")]),
                 lambda: visualize.ModelRunner("SRCNN", "missing.pth"),
                 lambda: generate_model_vis.main(["--out",
                                                  str(tmp_path / "vis"),
                                                  "--models", "SRCNN"]),
                 lambda: sweep.run_sweep(
                     str(ROOT / "configs" / "sweep_srcnn.yaml"), 1,
                     overrides={"dataset": "synthetic"},
                     out=str(tmp_path / "sweep.jsonl"))):
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
    # K1's plain version takes any odd size, as JAX's depthwise_blur_fast
    # does; the CUDA kernel has 5 taps compiled in and names the size it
    # refuses instead of falling back
    with pytest.raises(ValueError, match="odd"):
        blur_kernel(torch.rand(1, 1, 8, 8), size=4)
    for size in (3, 7):
        assert blur_kernel(x, size=size).shape == x.shape
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="size=7"):
            blur_kernel(x.cuda(), size=7)


def test_served_batchnorm_stays_float32_in_a_bf16_server():
    """The registry ResNetSR served in bf16 on the CPU: its convs in bf16,
    its BatchNorms' parameters and running stats in float32 (as the JAX
    package keeps them), also through a later ``.to(torch.bfloat16)``."""
    srv = SRServer("RESNET", dtype=torch.bfloat16, device="cpu")
    try:
        assert srv.model.input_conv.weight.dtype == torch.bfloat16
        bns = [m for m in srv.model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
        assert len(bns) == 33
        srv.model.to(torch.bfloat16)
        for m in bns:
            assert {t.dtype for t in (m.weight, m.bias, m.running_mean,
                                      m.running_var)} == {torch.float32}
    finally:
        srv.close()
