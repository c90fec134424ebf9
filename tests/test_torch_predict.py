"""The port's offline CLI (food101_sr_tpu_torch.predict) on the CPU:
input collection and output naming agree with the JAX package's
``predict.py`` on the same trees; end to end (small and tiled) every
output equals the engine's ``upscale`` of its input; an input the port
cannot decode is a counted failure named on stderr; the ``--strict``
exit codes; ``--quantize int8`` against the int8 engine."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

from food101_sr_tpu_torch import native, predict
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import predict as jax_predict  # noqa: E402


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _write_png(path, h, w, seed=0):
    img = _img(h, w, seed)
    path.write_bytes(native.encode_png_rgb8(img))
    return img


@pytest.fixture()
def tree(tmp_path):
    d = tmp_path / "imgs"
    (d / "sub").mkdir(parents=True)
    (d / "other").mkdir()
    for rel in ("a.png", "sub/b.jpg", "sub/a.PNG", "other/a.png", "c.webp"):
        _write_png(d / rel, 8, 8)
    (d / "notes.txt").write_text("not an image")
    return d


@pytest.mark.parametrize("patterns", [
    ["{d}"], ["{d}", "{d}/a.png", "{d}/*.png"], ["{d}/sub/*"],
    ["{d}", "{d}/nope_dir"], ["{d}/missing.png"], ["{d}/*.gif"]],
    ids=["dir", "dedup", "glob", "typo-dir", "missing-file", "no-match"])
def test_collect_inputs_matches_jax(tree, patterns):
    pats = [p.format(d=tree) for p in patterns]
    assert predict.collect_inputs(pats) == jax_predict.collect_inputs(pats)


@pytest.mark.parametrize("paths,suffix,ext", [
    (["a/cat.png", "b/cat.png", "c/cat.jpg", "dog.png"], "_x4", ".png"),
    (["x/cat.png", "cat_2_sr.png", "y/cat.png"], "_sr", ".jpg"),
    ([], "_x4", ".png")])
def test_output_names_match_jax(paths, suffix, ext):
    got = predict.output_names(paths, suffix, ext)
    assert got == jax_predict.output_names(paths, suffix, ext)
    assert len(set(got.values())) == len(paths)


def test_predict_end_to_end_small_and_tiled(tmp_path, capsys):
    src = tmp_path / "in"
    src.mkdir()
    imgs = {"small": _write_png(src / "small.png", 20, 24, seed=1),
            # > tile + 2*halo (16 + 2*8 for SRCNN) on both axes: tiled
            "big": _write_png(src / "big.png", 48, 56, seed=2)}
    (src / "corrupt.jpg").write_bytes(b"\xff\xd8 not actually a jpeg")
    (src / "bitmap.bmp").write_bytes(b"BM" + bytes(64))
    out = tmp_path / "out"
    predict.main([str(src), "--out_dir", str(out), "--architecture",
                  "SRCNN", "--tile", "16", "--max_batch", "4",
                  "--concurrency", "2", "--suffix", "_sr", "--dtype",
                  "float32", "--device", "cpu", "--warmup"])
    ref = SRServer("SRCNN", dtype=torch.float32, device="cpu", tile=16,
                   max_batch=4)
    try:
        for name, img in imgs.items():
            got = np.asarray(Image.open(out / f"{name}_sr.png"))
            assert got.shape == (4 * img.shape[0], 4 * img.shape[1], 3)
            assert np.array_equal(got, ref.upscale(img))
    finally:
        ref.close()
    assert not (out / "corrupt_sr.png").exists()
    captured = capsys.readouterr()
    summary = json.loads(captured.out.strip().splitlines()[-1])
    assert summary["n_images"] == 2 and summary["failed"] == 2
    assert summary["architecture"] == "SRCNN" and summary["scale"] == 4
    assert summary["images_per_s"] > 0 and summary["device"] == "cpu"
    assert "FAILED" in captured.err and "corrupt.jpg" in captured.err
    assert "UnsupportedImage" in captured.err and "BMP" in captured.err


@pytest.mark.parametrize("files,strict,code", [
    ({"ok.png": True, "bad.png": False}, True, 1),
    ({"ok.png": True, "bad.png": False}, False, None),
    ({"bad.png": False}, False, 1)],
    ids=["strict-partial", "partial", "all-failed"])
def test_strict_exit_codes(tmp_path, files, strict, code):
    src = tmp_path / "in"
    src.mkdir()
    for name, good in files.items():
        if good:
            _write_png(src / name, 8, 8, seed=1)
        else:
            (src / name).write_bytes(b"nope")
    argv = [str(src), "--out_dir", str(tmp_path / "out"), "--architecture",
            "SRCNN", "--tile", "16", "--device", "cpu", "--dtype", "float32"]
    if strict:
        argv.append("--strict")
    if code is None:
        predict.main(argv)
    else:
        with pytest.raises(SystemExit) as e:
            predict.main(argv)
        assert e.value.code == code
    assert (tmp_path / "out" / "ok_x4.png").exists() == ("ok.png" in files)


def test_quantize_int8_runs_on_the_cpu(tmp_path, capsys):
    """``--quantize int8`` (ROADMAP item 8): a narrow ResNetSR checkpoint
    through "auto", each output equal to an int8 server's ``upscale``."""
    from food101_sr_tpu_torch.models import ResNetSR, build_model
    from food101_sr_tpu_torch.training import save_checkpoint

    sd = build_model(lambda: ResNetSR(4, 16, 2), device="cpu").state_dict()
    ckpt = save_checkpoint(sd, str(tmp_path / "resnet_best.pth"))
    (tmp_path / "in").mkdir()
    img = _write_png(tmp_path / "in" / "a.png", 16, 16)
    predict.main([str(tmp_path / "in"), "--out_dir", str(tmp_path / "o"),
                  "--architecture", "auto", "--checkpoint", ckpt,
                  "--quantize", "int8", "--tile", "16", "--device", "cpu",
                  "--dtype", "float32"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_images"] == 1
    srv = SRServer("auto", checkpoint=ckpt, tile=16, device="cpu",
                   dtype=torch.float32, quantize="int8")
    try:
        assert srv.model.res_blocks[0].conv1.quantize == "int8"
        want = srv.upscale(img)
    finally:
        srv.close()
    got = native.decode_image((tmp_path / "o" / "a_x4.png").read_bytes())
    assert np.array_equal(got, want)
