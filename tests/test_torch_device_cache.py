"""The port's device cache (food101_sr_tpu_torch.data.device_cache) against
the JAX package's (food101_sr_tpu/data/device_cache.py) on the CPU, the
contract of JAX's tests/test_device_cache.py: the canvases byte-equal to
JAX's, eval batches byte-equal to JAX's loader and to the host loader's,
the epoch order JAX's, train crops windows of their canvas (flipped or
not) keyed by (seed, epoch, batch), the budget guard, and
train(cache_device=True)."""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.data import DeviceCacheLoader as JaxDeviceCacheLoader
from food101_sr_tpu.data import Food101Source as JaxFood101Source
from food101_sr_tpu.data import SyntheticSource as JaxSyntheticSource
from food101_sr_tpu.data import build_canvas_cache as jax_build_canvas_cache
from food101_sr_tpu_torch.data import (DeviceCacheLoader, Food101Source,
                                       SRDataLoader, SyntheticSource,
                                       build_canvas_cache)
from food101_sr_tpu_torch.training import train

JPEG_TREE = (Path(__file__).resolve().parent.parent / "food101_sr_tpu_torch"
             / "assets" / "jpeg")


def _batches(loader, epoch=0, start_batch=0):
    loader.set_epoch(epoch, start_batch)
    return [np.asarray(b) for b in loader]


def _find(crop: np.ndarray, canvas: np.ndarray):
    """(top, left, flipped) of ``crop`` as a window of ``canvas`` or of its
    mirror image, or None."""
    k, s = crop.shape[0], canvas.shape[0]
    for flipped, c in ((False, canvas), (True, canvas[:, ::-1])):
        for top in range(s - k + 1):
            for left in range(s - k + 1):
                if np.array_equal(c[top:top + k, left:left + k], crop):
                    return top, left, flipped
    return None


@pytest.mark.parametrize("which", ["synthetic", "food101"])
def test_canvases_equal_jax(which):
    """build_canvas_cache on the same source and indices: byte-equal
    canvases, resize-if-small included (the synthetic source's 160 px
    sides at canvas 200; the committed mini Food-101 tree's JPEGs through
    the port's own codec against JAX's decoder)."""
    if which == "synthetic":
        srcs = SyntheticSource(n=12, seed=4), JaxSyntheticSource(n=12, seed=4)
        idx, canvas = np.array([7, 2, 5, 10, 3]), 200
    else:
        srcs = (Food101Source(str(JPEG_TREE), "train"),
                JaxFood101Source(str(JPEG_TREE), "train"))
        idx, canvas = np.arange(min(len(srcs[0]), 8)), 96
    got = build_canvas_cache(srcs[0], idx, canvas)
    want = jax_build_canvas_cache(srcs[1], idx, canvas)
    assert got.shape == want.shape == (len(idx), canvas, canvas, 3)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_eval_batches_equal_jax_and_the_host_loader():
    """train=False (canvas = crop): batches byte-equal to JAX's
    DeviceCacheLoader and to the port's SRDataLoader."""
    kw = dict(indices=np.arange(20), crop_size=64, batch_size=8, train=False,
              seed=5)
    got = _batches(DeviceCacheLoader(SyntheticSource(n=24, seed=3),
                                     device="cpu", **kw))
    host = _batches(SRDataLoader(SyntheticSource(n=24, seed=3),
                                 device="cpu", **kw))
    jax_ = _batches(JaxDeviceCacheLoader(JaxSyntheticSource(n=24, seed=3),
                                         **kw))
    assert len(got) == len(host) == len(jax_) == 2
    for a, b, c in zip(got, host, jax_):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_train_batches_hold_the_samples_of_jax_epoch_order():
    """canvas = crop, so a train sample is its canvas, flipped or not: in
    every batch of epochs 0 and 1, each of the port's samples is JAX's
    sample at the same position or its mirror image (the epoch order
    (seed, epoch, 7) and drop-remainder are JAX's), and both flips
    occur."""
    kw = dict(indices=np.arange(3, 23), crop_size=32, batch_size=6,
              train=True, seed=2, canvas=32)
    port = DeviceCacheLoader(SyntheticSource(n=24, seed=1), device="cpu",
                             **kw)
    jx = JaxDeviceCacheLoader(JaxSyntheticSource(n=24, seed=1), **kw)
    flips = set()
    for epoch in (0, 1):
        got, want = _batches(port, epoch), _batches(jx, epoch)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                same, mirror = np.array_equal(x, y), np.array_equal(
                    x, y[:, ::-1])
                assert same or mirror
                flips.add(same)
    assert flips == {True, False}


def test_crops_are_windows_of_their_canvas_and_both_flips_occur():
    """64 draws of one image at canvas 64, crop 32: every crop is a
    window of the canvas or of its mirror image, more than 16 distinct,
    both flips and several offsets drawn."""
    src = SyntheticSource(n=2, seed=0)
    loader = DeviceCacheLoader(src, indices=np.zeros(64, np.int64),
                               crop_size=32, batch_size=64, train=True,
                               seed=0, canvas=64, shuffle=False,
                               device="cpu")
    (batch,) = _batches(loader)
    canvas = build_canvas_cache(src, np.array([0]), 64)[0]
    found = [_find(c, canvas) for c in batch]
    assert all(f is not None for f in found)
    assert {f[2] for f in found} == {False, True}
    assert len({f[:2] for f in found}) > 16
    assert len({c.tobytes() for c in batch}) > 16


def test_batches_are_a_function_of_seed_epoch_and_batch():
    """Two loaders give one epoch's batches equal; another epoch differs;
    set_epoch(e, start_batch=k) gives the tail of the full epoch e; a pass
    without set_epoch advances to the next epoch, as the host loader."""
    kw = dict(indices=np.arange(32), crop_size=48, batch_size=8, train=True,
              seed=9, canvas=96, device="cpu")
    a = DeviceCacheLoader(SyntheticSource(n=32, seed=1), **kw)
    b = DeviceCacheLoader(SyntheticSource(n=32, seed=1), **kw)
    full = _batches(a, epoch=2)
    assert len(full) == 4 and full[0].shape == (8, 48, 48, 3)
    for x, y in zip(full, _batches(b, epoch=2)):
        np.testing.assert_array_equal(x, y)
    tail = _batches(b, epoch=2, start_batch=1)
    assert len(tail) == 3
    for x, y in zip(full[1:], tail):
        np.testing.assert_array_equal(x, y)
    nxt = [np.asarray(t) for t in b]  # no set_epoch: epoch 3
    assert any(not np.array_equal(x, y) for x, y in zip(full, nxt))
    for x, y in zip(nxt, _batches(a, epoch=3)):
        np.testing.assert_array_equal(x, y)
    assert a.batches == 4 and a.wait_s == 0.0


def test_budget_guard_refuses_an_oversized_cache():
    with pytest.raises(ValueError, match="GiB"):
        DeviceCacheLoader(SyntheticSource(n=64, seed=0),
                          indices=np.arange(64), crop_size=200, batch_size=8,
                          train=True, canvas=512, max_cache_gb=0.01,
                          device="cpu")


def test_train_end_to_end_with_cache_device(tmp_path, monkeypatch):
    """train(cache_device=True) as JAX's test runs it (SRCNN, crop 32,
    canvas 48, one epoch; 48 synthetic images, 5 steps): finite metrics,
    PSNR above 0; a run preempted after 3 updates and resumed ends with a
    full-state checkpoint bit-equal to the uninterrupted run's."""
    from food101_sr_tpu_torch.training import load_checkpoint
    from test_torch_loop import _assert_same

    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    cfg = dict(architecture="SRCNN", epochs=1, batch_size=8,
               dataset="synthetic", synthetic_size=48, crop_size=32,
               scale_factor=4, weights_dir=str(tmp_path / "w"),
               cache_device=True, cache_canvas=48, log_every=1,
               use_wandb=False)
    out = train({**cfg, "save_name": "full", "run_name": "full"},
                device="cpu")
    assert all(np.isfinite(v) for v in out.values()) and out["psnr"] > 0
    part = train({**cfg, "save_name": "part", "run_name": "part",
                  "preempt_after_updates": 3}, device="cpu")
    assert part["preempted"] is True
    train({**cfg, "save_name": "part2", "run_name": "part2",
           "resume": str(tmp_path / "w" / "part_last.pth")}, device="cpu")
    _assert_same(load_checkpoint(str(tmp_path / "w" / "part2_last.pth")),
                 load_checkpoint(str(tmp_path / "w" / "full_last.pth")))
