"""The port's AOT serving artifact (food101_sr_tpu_torch.export_serving)
on the CPU: each exported program round-trips through torch.export.save
and load byte-equal to the live SRServer.forward_u8 (SRCNN and a 2 x 16
AttentionSR in float32 and bf16, --tta and int8); AttentionSR's graph
holds the registered K2 op once per block and no aten.mean; the manifest
has the JAX tool's keys; the program is within 1 uint8 level of JAX's
jax.export program on the same weights in float32; a fresh process loads
and runs it without any model module; an export leaves the live server's
caches real (the trace-poisoned cache repair); and K2's registered op
agrees with its autograd.Function bit for bit, forward and backward."""
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu_torch import export_serving
from food101_sr_tpu_torch.convert import params_from_jax
from food101_sr_tpu_torch.models import registry
from food101_sr_tpu_torch.models.attention_sr import AttentionSR
from food101_sr_tpu_torch.ops import spatial_mean as sm
from food101_sr_tpu_torch.serving import SRServer
from food101_sr_tpu_torch.training import save_checkpoint

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from tools import export_serving as jax_export_serving  # noqa: E402

BLOCKS, WIDTH = 2, 16
K2_OP = "f101.spatial_mean"
LEVEL_TOL = 1  # uint8 levels, port program vs JAX program, float32:
#                the same sums in another order, then one rounding


def _narrow(scale, **flags):
    return AttentionSR(scale_factor=scale, num_residuals=BLOCKS,
                       num_channels=WIDTH, **flags)


@pytest.fixture()
def narrow(monkeypatch):
    monkeypatch.setitem(registry._REGISTRY, "AttentionSR", _narrow)


def _export(out, arch, *extra, shapes="8x8"):
    return export_serving.main(["--architecture", arch, "--out", str(out),
                                "--shapes", shapes, "--batch", "2", "--cpu",
                                "--check", *extra])


def _k2_nodes(ep) -> int:
    return sum(1 for n in ep.graph.nodes if n.op == "call_function"
               and str(n.target).startswith(K2_OP))


def _means(ep) -> int:
    return sum(1 for n in ep.graph.nodes if n.op == "call_function"
               and "aten.mean" in str(n.target))


@pytest.mark.parametrize("arch,extra", [
    ("SRCNN", ("--dtype", "float32")),
    ("SRCNN", ()),
    ("AttentionSR", ("--dtype", "float32")),
    ("AttentionSR", ()),
    ("AttentionSR", ("--tta",)),
    ("AttentionSR", ("--quantize", "int8")),
], ids=["srcnn-f32", "srcnn-bf16", "attn-f32", "attn-bf16", "attn-tta",
        "attn-int8"])
def test_round_trip_byte_equal(narrow, tmp_path, arch, extra):
    """--check holds every loaded program byte-equal to the live forward
    (SystemExit otherwise); the manifest describes the files; the weights
    come back from the file in the layout the server runs them in
    (channels-last for the float convs; the int8 bodies' float32 weights
    as the quantized server holds them); AttentionSR's graph holds the K2
    op once per block of each forward and no aten.mean."""
    two = arch == "SRCNN" and not extra
    summary = _export(tmp_path, arch, *extra,
                      shapes="8x8,12x20" if two else "8x8")
    assert summary["checked"] == summary["buckets"] == (2 if two else 1)
    man = json.loads((tmp_path / "manifest.json").read_text())
    assert man["architecture"] == arch and man["scale"] == 4
    for b in man["buckets"]:
        blob = (tmp_path / b["file"]).read_bytes()
        assert b["file"].endswith("_b2.pt2")
        assert len(blob) == b["bytes"]
        assert hashlib.sha256(blob).hexdigest() == b["sha256"]
        assert b["platforms"] == ["cpu"]
        assert b["sr_shape"] == [2, b["lr_shape"][1] * 4,
                                 b["lr_shape"][2] * 4, 3]
    prog = export_serving.load_bucket(
        str(tmp_path / man["buckets"][0]["file"]), device="cpu").program
    srv = SRServer(arch, device="cpu", quantize=man["quantize"],
                   dtype=getattr(torch, man["dtype"]))
    try:
        live = dict(srv.model.named_parameters())
        for name, t in prog.state_dict.items():
            want = live[name.removeprefix("net.")]
            assert (t.dtype, t.shape, t.stride()) == \
                (want.dtype, want.shape, want.stride()), name
    finally:
        srv.close()
    if arch == "AttentionSR":
        per_forward = 2 if "--tta" in extra else 1  # two ensemble forwards
        assert _k2_nodes(prog) == BLOCKS * per_forward
        assert _means(prog) == 0  # the SE squeeze is the op, not aten.mean


def test_manifest_keys_match_jax(tmp_path):
    """The JAX tool's manifest keys and values, but jax_version ->
    torch_version and the new ops_module; buckets alike but the file
    extension."""
    argv = ["--architecture", "SRCNN", "--shapes", "8x8", "--batch", "2",
            "--cpu"]
    jax_export_serving.main([*argv, "--out", str(tmp_path / "jax")])
    export_serving.main([*argv, "--out", str(tmp_path / "port")])
    jm = json.loads((tmp_path / "jax" / "manifest.json").read_text())
    pm = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert set(pm) == set(jm) - {"jax_version"} | {"torch_version",
                                                     "ops_module"}
    assert pm["torch_version"] == torch.__version__
    assert pm["ops_module"] == "food101_sr_tpu_torch.ops"
    for key in ("kind", "architecture", "scale", "dtype", "quantize", "tta",
                "phase_tail", "checkpoint", "n_params", "io"):
        assert pm[key] == jm[key], key
    (jb,), (pb,) = jm["buckets"], pm["buckets"]
    assert set(pb) == set(jb)
    for key in ("lr_shape", "sr_shape", "platforms"):
        assert pb[key] == jb[key], key
    assert pb["file"].removesuffix(".pt2") == \
        jb["file"].removesuffix(".jaxexport")


def _jax_narrow(scale, dtype, remat, quantize, phase_tail):
    from food101_sr_tpu.models.attention_sr import AttentionSR as JaxAttn

    return JaxAttn(scale_factor=scale, num_residuals=BLOCKS,
                   num_channels=WIDTH, dtype=dtype, remat=remat,
                   quantize=quantize, phase_tail=phase_tail)


@pytest.mark.parametrize("arch", ["SRCNN", "AttentionSR"])
def test_program_matches_jax_program(monkeypatch, tmp_path, arch):
    """JAX's seeded server in float32 and its jax.export program; the
    port's program of the same weights (converted, exported from a
    checkpoint with --architecture auto); the two programs' outputs on
    the same uint8 batch within LEVEL_TOL."""
    from food101_sr_tpu.models import registry as jax_registry
    from jax import export as jexport

    monkeypatch.setitem(jax_registry._REGISTRY, "AttentionSR", _jax_narrow)
    jsrv = jax_serve.SRServer(arch, None, scale=4, dtype=jnp.float32,
                              max_batch=2)
    jprog = jexport.export(jsrv._fwd)(
        jax.ShapeDtypeStruct((2, 8, 12, 3), jnp.uint8))
    ckpt = save_checkpoint(params_from_jax(jsrv.variables["params"]),
                           str(tmp_path / "w.pth"))
    _export(tmp_path / "aot", "auto", "--checkpoint", ckpt, "--dtype",
            "float32", shapes="8x12")
    prog = export_serving.load_bucket(
        str(tmp_path / "aot" / "sr_8x12_b2.pt2"), device="cpu")
    x = np.random.default_rng(7).integers(0, 256, (2, 8, 12, 3), np.uint8)
    got, want = prog(x), np.asarray(jprog.call(x))
    assert got.shape == want.shape == (2, 32, 48, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= LEVEL_TOL


_LOADER = """
import sys, hashlib, numpy as np
from food101_sr_tpu_torch.export_serving import load_bucket
run = load_bucket(sys.argv[1], device="cpu")
x = np.random.default_rng(3).integers(0, 256, (2, 8, 8, 3), np.uint8)
y = run(x)
bad = sorted(m for m in sys.modules if m.startswith((
    "food101_sr_tpu_torch.models", "food101_sr_tpu_torch.serving")))
print(y.dtype, y.shape, hashlib.sha256(y.tobytes()).hexdigest(), bad)
"""


def test_loader_needs_no_model_code(narrow, tmp_path):
    """The deployment contract: a fresh process imports the loader (and so
    the ops module), loads and calls the program, and imports no model or
    server module; its bytes are the live forward's."""
    _export(tmp_path, "AttentionSR")
    path = tmp_path / "sr_8x8_b2.pt2"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _LOADER, str(path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    srv = SRServer("AttentionSR", device="cpu", max_batch=2)
    try:
        x = np.random.default_rng(3).integers(0, 256, (2, 8, 8, 3),
                                              np.uint8)
        want = srv.forward_u8(torch.from_numpy(x)).numpy()
    finally:
        srv.close()
    digest = hashlib.sha256(want.tobytes()).hexdigest()
    assert proc.stdout.split() == ["uint8", "(2,", "32,", "32,", "3)",
                                   digest, "[]"]


def test_bad_shapes_and_devices_rejected(narrow, tmp_path):
    for bad in ("64", "0x64", "x", ",", "8x-8"):
        with pytest.raises(SystemExit):
            export_serving.main(["--architecture", "SRCNN", "--out",
                                 str(tmp_path / "x"), "--shapes", bad,
                                 "--cpu"])
    assert export_serving.parse_shapes(" 64x48, 8X8 ,") == [(64, 48), (8, 8)]
    _export(tmp_path, "SRCNN")
    with pytest.raises(ValueError, match="exported for cpu"):
        export_serving.load_bucket(str(tmp_path / "sr_8x8_b2.pt2"),
                                   device="cuda")


_POISON = """
import sys, hashlib, numpy as np, torch
from food101_sr_tpu_torch.models import layers, registry
from food101_sr_tpu_torch.models.attention_sr import AttentionSR
from food101_sr_tpu_torch.ops import subpixel_conv
from food101_sr_tpu_torch.export_serving import export_bucket
from food101_sr_tpu_torch.serving import SRServer
registry._REGISTRY["AttentionSR"] = lambda scale, **f: AttentionSR(
    scale_factor=scale, num_residuals=2, num_channels=16, **f)
subpixel_conv._device_index.cache_clear()
layers.scalar_in.cache_clear()
srv = SRServer("AttentionSR", device="cpu", max_batch=2)
eps = [export_bucket(srv, 8, 8, 2) for _ in range(2)]  # first calls: traced
x = torch.from_numpy(np.random.default_rng(5).integers(
    0, 256, (2, 8, 8, 3), np.uint8))
y = srv.forward_u8(x)
srv.close()
print(type(y).__name__, hashlib.sha256(y.numpy().tobytes()).hexdigest(),
      len(eps))
"""


def test_export_leaves_the_live_server_real(tmp_path):
    """In a fresh process with the caches cleared, two exports of the
    bf16 AttentionSR server come first (the phase tail's index cache and
    scalar_in are first filled under the trace); the eager forward after
    them returns a real tensor, bit-equal to a server never exported."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _POISON], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    kind, digest, n = proc.stdout.split()
    ref = SRServer(model=_build_narrow(), device="cpu", max_batch=2)
    try:
        x = np.random.default_rng(5).integers(0, 256, (2, 8, 8, 3),
                                              np.uint8)
        want = ref.forward_u8(torch.from_numpy(x)).numpy()
    finally:
        ref.close()
    assert (kind, n) == ("Tensor", "2")
    assert digest == hashlib.sha256(want.tobytes()).hexdigest()


def _build_narrow():
    return registry.build_model(lambda: _narrow(4, phase_tail=True),
                                dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [torch.channels_last,
                                    torch.contiguous_format])
def test_k2_op_matches_the_autograd_function(dtype, layout):
    """The registered op and the eager autograd.Function: forward bit for
    bit; the float32 gradient bit for bit (bf16's too)."""
    gen = torch.Generator().manual_seed(11)
    x = torch.rand((3, 24, 7, 5), generator=gen).to(dtype) \
        .contiguous(memory_format=layout)
    g = torch.rand((3, 24), generator=gen).to(dtype)
    outs = []
    for fn in (sm._SpatialMean.apply, sm.spatial_mean_op):
        xa = x.clone().requires_grad_(True)
        y = fn(xa)
        (y * g).sum().backward()
        outs.append((y.detach(), xa.grad))
    (ya, ga), (yb, gb) = outs
    assert ya.dtype == yb.dtype == dtype and ya.shape == (3, 24)
    assert torch.equal(ya, yb) and torch.equal(ga, gb)
    assert torch.equal(ya, sm.spatial_mean_plain(x))


def test_spatial_mean_routes_through_the_op_only_when_exporting(monkeypatch):
    """Eager calls take the autograd.Function (less host time per call);
    under an export the op, which the trace records."""
    calls = []
    monkeypatch.setattr(sm, "spatial_mean_op",
                        lambda x: calls.append("op") or sm.mean_kernel(x))
    x = torch.rand(2, 8, 4, 4)
    sm.spatial_mean(x)
    assert calls == []
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    sm.spatial_mean(x)
    assert calls == ["op"]
