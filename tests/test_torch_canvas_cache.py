"""The port's disk canvas store and its two loaders
(food101_sr_tpu_torch.data.canvas_cache) against the JAX package's
(food101_sr_tpu/data/canvas_cache.py) on the CPU, the contract of JAX's
tests/test_canvas_cache.py: one store layout and content key for both
packages (a store either builds opens in the other), stores reused and
not rebuilt, eval batches byte-equal to JAX's and to the host loader's,
train batches a function of (seed, epoch, batch), the budget guards, the
window loader's shapes, determinism, resume jumps, coverage and refresh
stream (JAX's, canvas for canvas), its refusals, the exclusivity of the
two caches, and train(cache_host=...) with and without reuse."""
import os

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.data import CanvasStore as JaxCanvasStore
from food101_sr_tpu.data import DeviceWindowLoader as JaxDeviceWindowLoader
from food101_sr_tpu.data import HostCanvasLoader as JaxHostCanvasLoader
from food101_sr_tpu.data import SyntheticSource as JaxSyntheticSource
from food101_sr_tpu_torch.data import (CanvasStore, DeviceWindowLoader,
                                       HostCanvasLoader, SRDataLoader,
                                       SyntheticSource)
from food101_sr_tpu_torch.training import train


def _batches(loader, epoch=0, start_batch=0):
    loader.set_epoch(epoch, start_batch)
    return [np.asarray(b) for b in loader]


def _equal_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_a_store_either_package_builds_opens_in_the_other(builder, tmp_path):
    """Same key, same directory, same rows and canvases, the reader's
    open_or_build finds the store instead of building one."""
    idx = np.array([7, 2, 5], np.int64)
    port_src, jax_src = SyntheticSource(n=10, seed=4), \
        JaxSyntheticSource(n=10, seed=4)
    assert port_src.fingerprint() == jax_src.fingerprint()
    assert CanvasStore.key(port_src, idx, 64) == \
        JaxCanvasStore.key(jax_src, idx, 64)
    if builder == "jax":
        built = JaxCanvasStore.open_or_build(jax_src, idx, 64, str(tmp_path))
        opened = CanvasStore.open_or_build(port_src, idx, 64, str(tmp_path))
    else:
        built = CanvasStore.open_or_build(port_src, idx, 64, str(tmp_path))
        opened = JaxCanvasStore.open_or_build(jax_src, idx, 64,
                                              str(tmp_path))
    assert opened.path == built.path and len(os.listdir(tmp_path)) == 1
    assert len(opened) == 3 and opened.canvas == 64
    assert opened.meta == built.meta and opened.meta["version"] == 1
    np.testing.assert_array_equal(opened.rows, idx)
    np.testing.assert_array_equal(np.asarray(opened.canvases),
                                  np.asarray(built.canvases))
    assert opened.row_for(5) == 2


def test_store_is_reused_not_rebuilt(tmp_path):
    src = SyntheticSource(n=6, seed=1)
    idx = np.arange(6)
    a = CanvasStore.open_or_build(src, idx, 48, str(tmp_path))
    mtime = os.path.getmtime(os.path.join(a.path, "canvases.npy"))
    b = CanvasStore.open_or_build(src, idx, 48, str(tmp_path))
    assert b.path == a.path
    assert os.path.getmtime(os.path.join(b.path, "canvases.npy")) == mtime
    c = CanvasStore.open_or_build(src, idx, 56, str(tmp_path))
    d = CanvasStore.open_or_build(src, idx[:4], 48, str(tmp_path))
    assert len({a.path, c.path, d.path}) == 3
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".")]


def test_eval_batches_equal_jax_and_the_host_loader(tmp_path):
    kw = dict(indices=np.arange(20), crop_size=64, batch_size=8, train=False,
              seed=5)
    got = _batches(HostCanvasLoader(SyntheticSource(n=24, seed=3),
                                    device="cpu",
                                    cache_dir=str(tmp_path / "p"), **kw))
    host = _batches(SRDataLoader(SyntheticSource(n=24, seed=3),
                                 device="cpu", **kw))
    jax_ = _batches(JaxHostCanvasLoader(JaxSyntheticSource(n=24, seed=3),
                                        cache_dir=str(tmp_path / "j"), **kw))
    assert len(got) == 2
    _equal_lists(got, host)
    _equal_lists(got, jax_)


def test_train_determinism_and_epoch_variation(tmp_path):
    """Batches a function of (seed, epoch, batch): two loaders agree, a
    start_batch gives the epoch's tail, another epoch differs; the
    augmentation is device_cache's (the same batches as DeviceCacheLoader
    on the same canvases)."""
    from food101_sr_tpu_torch.data import DeviceCacheLoader

    src = SyntheticSource(n=32, seed=1)
    kw = dict(indices=np.arange(32), crop_size=48, batch_size=8, train=True,
              seed=9, canvas=96, device="cpu")
    a = HostCanvasLoader(src, cache_dir=str(tmp_path), **kw)
    b = HostCanvasLoader(src, cache_dir=str(tmp_path), **kw)
    ba = _batches(a, epoch=2)
    assert len(ba) == 4 and ba[0].shape == (8, 48, 48, 3)
    _equal_lists(ba, _batches(b, epoch=2))
    _equal_lists(ba[2:], _batches(b, epoch=2, start_batch=2))
    _equal_lists(ba, _batches(DeviceCacheLoader(src, **kw), epoch=2))
    bc = _batches(b, epoch=3)
    assert any(not np.array_equal(x, y) for x, y in zip(ba, bc))
    assert a.batches == 4


def test_crops_and_flips_are_really_drawn(tmp_path):
    loader = HostCanvasLoader(SyntheticSource(n=2, seed=0),
                              indices=np.zeros(64, np.int64), crop_size=32,
                              batch_size=64, train=True, seed=0, canvas=128,
                              shuffle=False, cache_dir=str(tmp_path),
                              device="cpu")
    (batch,) = _batches(loader)
    assert len({batch[i].tobytes() for i in range(64)}) > 16


def test_budget_guard_refuses_an_oversized_store(tmp_path):
    with pytest.raises(ValueError, match="GiB"):
        HostCanvasLoader(SyntheticSource(n=64, seed=0),
                         indices=np.arange(64), crop_size=200, batch_size=8,
                         train=True, canvas=512, cache_dir=str(tmp_path),
                         max_store_gb=0.01, device="cpu")


# ---------------------------------------------------------------------------
# the device window (DeviceWindowLoader, --cache_host_reuse)
# ---------------------------------------------------------------------------

def test_window_loader_shapes_and_determinism(tmp_path):
    src = SyntheticSource(n=48, seed=2)
    kw = dict(indices=np.arange(48), crop_size=32, batch_size=8, seed=3,
              canvas=64, cache_dir=str(tmp_path), reuse=4, window=16,
              device="cpu")
    a = DeviceWindowLoader(src, **kw)
    assert len(a) == 6 and a.window == 16 and a._refresh == 2
    ba = _batches(a, epoch=0)
    assert len(ba) == 6 and ba[0].shape == (8, 32, 32, 3)
    assert ba[0].dtype == np.uint8
    b = DeviceWindowLoader(src, **kw)
    _equal_lists(ba, _batches(b, epoch=0))
    bc = _batches(b, epoch=1)
    assert any(not np.array_equal(x, y) for x, y in zip(ba, bc))
    assert a.batches == 6


def test_window_loader_jumps_equal_sequential_iteration(tmp_path):
    """The window is a function of the stream position: jumping straight
    to epoch 2 (a resume at an epoch boundary), or into the middle of
    epoch 1 (a mid-epoch resume, where the ring's rows are rolled), gives
    the batches a sequential run draws there."""
    src = SyntheticSource(n=32, seed=5)
    kw = dict(indices=np.arange(32), crop_size=24, batch_size=8, seed=1,
              canvas=48, cache_dir=str(tmp_path), reuse=2, window=12,
              device="cpu")
    seq = DeviceWindowLoader(src, **kw)
    e0, e1, e2 = (_batches(seq, epoch=e) for e in range(3))
    _equal_lists(e2, _batches(DeviceWindowLoader(src, **kw), epoch=2))
    _equal_lists(e1[3:], _batches(DeviceWindowLoader(src, **kw), epoch=1,
                                  start_batch=3))


def test_window_loader_covers_the_dataset(tmp_path):
    """Each canvas is uploaded once every ``reuse`` epochs: the stream
    visits every source index once per N positions, and the epochs
    consume it contiguously."""
    ld = DeviceWindowLoader(SyntheticSource(n=24, seed=0),
                            indices=np.arange(24), crop_size=16,
                            batch_size=8, seed=0, canvas=32,
                            cache_dir=str(tmp_path), reuse=2, window=8,
                            device="cpu")
    per_epoch = len(ld) * ld._refresh  # 3 steps x 4 slots
    assert per_epoch * ld.reuse == 24
    srcs = [int(ld._perm(p // 24)[p % 24]) for p in range(24)]
    assert sorted(srcs) == list(range(24))
    assert ld._epoch_start_pos(1) - ld._epoch_start_pos(0) == per_epoch


def test_window_loader_refresh_stream_and_window_equal_jax(tmp_path):
    """Canvas for canvas, JAX's: the window's geometry (size, refresh
    quantum), the stream chunks at positions inside and across epoch
    boundaries, and the rebuilt window of a resume (rows rolled to their
    ring slots)."""
    kw = dict(indices=np.arange(3, 29), crop_size=24, batch_size=8, seed=4,
              canvas=40, cache_dir=str(tmp_path), reuse=3)
    port = DeviceWindowLoader(SyntheticSource(n=30, seed=6), device="cpu",
                              **kw)
    jx = JaxDeviceWindowLoader(JaxSyntheticSource(n=30, seed=6), **kw)
    assert (port.window, port._refresh) == (jx.window, jx._refresh)
    for start, count in ((0, 5), (23, 6), (51, 9), (port.window, 3)):
        np.testing.assert_array_equal(port._stream_chunk(start, count),
                                      jx._stream_chunk(start, count))
    pos = port._epoch_start_pos(2) + 2 * port._refresh
    assert pos == jx._epoch_start_pos(2) + 2 * jx._refresh
    port._rebuild_window(pos)
    jx._rebuild_window(pos)
    np.testing.assert_array_equal(port._window_dev.numpy(),
                                  np.asarray(jx._window_dev))


def test_window_loader_draws_vary_within_epoch(tmp_path):
    ld = DeviceWindowLoader(SyntheticSource(n=16, seed=7),
                            indices=np.arange(16), crop_size=24,
                            batch_size=16, seed=0, canvas=48,
                            cache_dir=str(tmp_path), reuse=4, window=8,
                            device="cpu")
    flat = [b[i].tobytes() for b in _batches(ld) for i in range(b.shape[0])]
    assert len(set(flat)) > len(flat) // 2


def test_window_loader_refuses_eval_and_an_oversized_window(tmp_path):
    src = SyntheticSource(n=8, seed=0)
    with pytest.raises(ValueError, match="train-only"):
        DeviceWindowLoader(src, train=False, cache_dir=str(tmp_path),
                           device="cpu")
    with pytest.raises(ValueError, match="GiB"):
        DeviceWindowLoader(src, indices=np.arange(8), crop_size=64,
                           batch_size=4, canvas=512, window=8,
                           cache_dir=str(tmp_path), window_budget_gb=0.001,
                           device="cpu")


# ---------------------------------------------------------------------------
# train()
# ---------------------------------------------------------------------------

def test_cache_device_and_cache_host_are_exclusive(tmp_path):
    with pytest.raises(ValueError, match="exclusive"):
        train(dict(architecture="SRCNN", epochs=1, batch_size=8,
                   dataset="synthetic", synthetic_size=96, crop_size=32,
                   weights_dir=str(tmp_path), save_name="x",
                   cache_device=True, cache_host=str(tmp_path / "store"),
                   use_wandb=False), device="cpu")


@pytest.mark.parametrize("reuse", [0, 4])
def test_train_end_to_end_with_cache_host(reuse, tmp_path, monkeypatch):
    """train(cache_host=DIR) as JAX's tests run it (SRCNN, crop 32, canvas
    48, 2 epochs; the window loader of 16 canvases with reuse 4): finite
    metrics, the train and eval stores on disk, and a second run opens
    them and ends with the same metrics."""
    monkeypatch.setenv("FOOD101_SR_RUN_DIR", str(tmp_path / "runs"))
    cfg = dict(architecture="SRCNN", epochs=2, batch_size=8,
               dataset="synthetic", synthetic_size=48, crop_size=32,
               weights_dir=str(tmp_path / "w"), save_name="host",
               cache_host=str(tmp_path / "store"), cache_host_reuse=reuse,
               cache_window=16, cache_canvas=48, log_every=1,
               use_wandb=False)
    out = train(cfg, device="cpu")
    assert all(np.isfinite(v) for v in out.values()) and out["psnr"] > 0
    stores = sorted(d for d in os.listdir(tmp_path / "store")
                    if d.startswith("canvas_"))
    assert len(stores) == 3  # train canvases, val and test crops
    again = train(cfg, device="cpu")
    assert again == out
    assert sorted(os.listdir(tmp_path / "store")) == stores
