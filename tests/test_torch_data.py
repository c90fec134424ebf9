"""The port's input pipeline and schedules (food101_sr_tpu_torch.data,
training.schedule) against the JAX package on the CPU: Pillow's bicubic
resize byte for byte, the synthetic source's bytes, the seeded splits,
SRDataLoader batches byte for byte over two epochs (with the resize at
crop 200), the mid-epoch fast-forward, the worker-error path, and the
plateau and early-stop decisions; and over a Food-101-layout JPEG tree,
Food101Source, load_sample (the region decode and the resize path) and
the loader's batches. Every comparison here is exact: the pipeline moves
uint8 bytes and the schedules compare Python floats."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

from food101_sr_tpu.data import Food101Source as JaxFood101
from food101_sr_tpu.data import SRDataLoader as JaxLoader
from food101_sr_tpu.data import SyntheticSource as JaxSource
from food101_sr_tpu.data import load_sample as jax_load_sample
from food101_sr_tpu.data import subset_indices as jax_subset_indices
from food101_sr_tpu.data import train_val_split as jax_train_val_split
from food101_sr_tpu.training.schedule import EarlyStopping as JaxStopper
from food101_sr_tpu.training.schedule import ReduceLROnPlateau as JaxPlateau
from food101_sr_tpu_torch.data import (Food101Source, SRDataLoader,
                                       SyntheticSource, load_hr_crop,
                                       load_sample, resize_bicubic_u8,
                                       subset_indices, train_val_split)
from food101_sr_tpu_torch.native import UnsupportedImage
from food101_sr_tpu_torch.training import EarlyStopping, ReduceLROnPlateau

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from tools.make_fake_food101 import make_image  # noqa: E402


# (in_h, in_w) -> (out_w, out_h), PIL's order: the loader's 160x200 -> 250x200
# at crop 200, odd sizes, upsizes along one axis only (one pass skipped),
# and a downsize (stretched filter support)
@pytest.mark.parametrize("in_hw,out_wh", [
    ((160, 200), (250, 200)), ((61, 37), (200, 330)), ((150, 200), (266, 200)),
    ((201, 100), (200, 402)), ((7, 5), (13, 11)), ((120, 200), (200, 333)),
    ((200, 120), (200, 333)), ((64, 50), (50, 97)), ((90, 131), (47, 33)),
])
def test_resize_equals_pillow_bicubic(in_hw, out_wh):
    img = np.random.default_rng(sum(in_hw)).integers(
        0, 256, (*in_hw, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(out_wh, Image.BICUBIC))
    got = resize_bicubic_u8(img, out_wh)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_refuses_float_input():
    with pytest.raises(ValueError, match="uint8"):
        resize_bicubic_u8(np.zeros((8, 8, 3), np.float32), (16, 16))


def test_synthetic_source_bytes_equal_jax():
    ours, theirs = SyntheticSource(n=8, seed=3), JaxSource(n=8, seed=3)
    assert len(ours) == len(theirs)
    for i in range(8):
        want = np.asarray(theirs[i], dtype=np.uint8)
        got = ours[i]
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_load_hr_crop_grey_image_equals_jax():
    """A 2-D (grey) image gives three equal channels, resized or not."""
    from food101_sr_tpu.data import load_hr_crop as jax_load_hr_crop

    grey = np.random.default_rng(4).integers(0, 256, (40, 56), np.uint8)
    for crop in (32, 48):
        got = load_hr_crop(grey, crop, True, np.random.default_rng(9))
        want = jax_load_hr_crop(Image.fromarray(grey), crop, True,
                                np.random.default_rng(9))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,fraction,seed", [(96, 1.0, 0), (101, 0.3, 5),
                                              (17, 0.5, 2)])
def test_subset_and_split_equal_jax(n, fraction, seed):
    idx = subset_indices(n, fraction, seed)
    np.testing.assert_array_equal(idx, jax_subset_indices(n, fraction, seed))
    for a, b in zip(train_val_split(idx, 0.1, seed + 1),
                    jax_train_val_split(idx, 0.1, seed + 1)):
        np.testing.assert_array_equal(a, b)


def _epochs(loader, n_epochs=2):
    out = []
    for e in range(n_epochs):
        loader.set_epoch(e)
        out.append([np.asarray(b) for b in loader])
    return out


# crop 200 takes Pillow's resize on every fourth synthetic image (160x200);
# crop 64 crops every image directly
@pytest.mark.parametrize("crop", [200, 64])
def test_loader_batches_equal_jax(crop):
    n, batch = 14, 4
    for train in (True, False):
        kw = dict(indices=np.arange(1, n), crop_size=crop, batch_size=batch,
                  train=train, seed=7, num_workers=3)
        ours = SRDataLoader(SyntheticSource(n=n, seed=1), device="cpu", **kw)
        theirs = JaxLoader(JaxSource(n=n, seed=1), **kw)
        assert len(ours) == len(theirs) == 3
        got, want = _epochs(ours), _epochs(theirs)
        for ge, we in zip(got, want):
            assert len(ge) == len(we) == 3
            for g, w in zip(ge, we):
                assert g.dtype == np.uint8 and g.shape == (batch, crop, crop, 3)
                np.testing.assert_array_equal(g, w)
        if train:  # the second epoch reshuffles and redraws
            assert not np.array_equal(got[0][0], got[1][0])
    assert ours.batches == 3 and ours.produce_s > 0.0 and ours.wait_s >= 0.0


def test_loader_fast_forward_equals_uninterrupted_tail():
    kw = dict(crop_size=48, batch_size=4, train=True, seed=7, num_workers=2)
    theirs = JaxLoader(JaxSource(n=20, seed=2), **kw)
    theirs.set_epoch(1)
    full = [np.asarray(b) for b in theirs]
    ours = SRDataLoader(SyntheticSource(n=20, seed=2), device="cpu", **kw)
    ours.set_epoch(1, start_batch=2)
    tail = [b.numpy() for b in ours]
    assert len(tail) == len(full) - 2
    for a, b in zip(full[2:], tail):
        np.testing.assert_array_equal(a, b)
    # one-shot: the next pass of that epoch starts from the top again
    ours.set_epoch(1)
    np.testing.assert_array_equal(next(iter(ours)).numpy(), full[0])


class _Failing(SyntheticSource):
    def __getitem__(self, i):
        if i == 5:
            raise OSError("corrupt image")
        return super().__getitem__(i)


def test_loader_worker_error_raises_and_stops_the_producer():
    loader = SRDataLoader(_Failing(n=12), crop_size=32, batch_size=4,
                          train=False, device="cpu", num_workers=2)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        list(loader)
    assert isinstance(info.value.__cause__, OSError)
    # a consumer that stops early leaves no producer behind
    import threading
    before = threading.active_count()
    it = iter(SRDataLoader(SyntheticSource(n=40), crop_size=32, batch_size=2,
                           train=True, device="cpu", prefetch=1))
    assert next(it).shape == (2, 32, 32, 3)
    it.close()
    assert threading.active_count() <= before


# ---------------------------------------------------------------------------
# Food-101 layout: a small tree of make_fake_food101 images at crop 64
# ---------------------------------------------------------------------------

FOOD_CROP = 64
# (h, w, mode, progressive): most take the region path; two are below the
# crop (the resize path); one grey, one progressive
FOOD_TRAIN = [(70, 90, "RGB", False), (96, 64, "RGB", False),
              (80, 81, "RGB", True), (64, 64, "RGB", False),
              (50, 77, "RGB", False), (73, 99, "L", False),
              (88, 70, "RGB", False), (66, 100, "RGB", False),
              (91, 65, "RGB", False), (60, 40, "RGB", False)]
FOOD_TEST = [(75, 85, "RGB", False), (64, 90, "RGB", False),
             (100, 70, "RGB", False), (82, 66, "L", False)]


def _food_tree(root: Path, splits: dict, seed: int = 0) -> Path:
    """root/food-101/images/<class>/<id>.jpg and meta/{split}.txt, saved
    at make_fake_food101's quality 92."""
    base = root / "food-101"
    (base / "meta").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    n = 0
    for split, shapes in splits.items():
        rel = []
        for h, w, mode, progressive in shapes:
            cls = ("pizza", "sushi", "ramen")[n % 3]
            (base / "images" / cls).mkdir(parents=True, exist_ok=True)
            name = f"{cls}/{1000000 + n}"
            Image.fromarray(make_image(rng, h, w)).convert(mode).save(
                base / "images" / f"{name}.jpg", quality=92,
                progressive=progressive)
            rel.append(name)
            n += 1
        (base / "meta" / f"{split}.txt").write_text("\n".join(rel) + "\n")
    return root


@pytest.fixture(scope="module")
def food_tree(tmp_path_factory):
    return _food_tree(tmp_path_factory.mktemp("food"),
                      {"train": FOOD_TRAIN, "test": FOOD_TEST})


def test_food101_source_equals_jax(food_tree, tmp_path):
    for split in ("train", "test"):
        ours = Food101Source(str(food_tree), split)
        theirs = JaxFood101(str(food_tree), split)
        assert ours.paths == theirs.paths and len(ours) == len(theirs)
        assert ours.fingerprint() == theirs.fingerprint()
        for i in range(len(ours)):
            assert ours.bytes_at(i) == theirs.bytes_at(i)
            got, want = ours[i], np.asarray(theirs[i], np.uint8)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    # the torchvision-written .json split lists
    meta = food_tree / "food-101" / "meta"
    lines = (meta / "test.txt").read_text().split()
    alt = tmp_path / "alt" / "food-101"
    (alt / "meta").mkdir(parents=True)
    (alt / "images").symlink_to(food_tree / "food-101" / "images")
    (alt / "meta" / "test.json").write_text(json.dumps(
        {"a": lines[:2], "b": lines[2:]}))
    assert Food101Source(str(tmp_path / "alt"), "test").paths == \
        JaxFood101(str(tmp_path / "alt"), "test").paths
    msgs = []
    for source in (Food101Source, JaxFood101):
        with pytest.raises(FileNotFoundError) as e:
            source(str(tmp_path / "missing"), "train")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("Food-101 metadata not found under")
    assert SyntheticSource(n=9, seed=2).fingerprint() == \
        JaxSource(n=9, seed=2).fingerprint()


def test_load_sample_equals_jax(food_tree):
    ours = Food101Source(str(food_tree), "train")
    theirs = JaxFood101(str(food_tree), "train")
    for i in range(len(ours)):
        for train in (True, False):
            for seed in range(3):
                got = load_sample(ours, i, FOOD_CROP, train,
                                  np.random.default_rng((seed, i)))
                want = jax_load_sample(theirs, i, FOOD_CROP, train,
                                       np.random.default_rng((seed, i)))
                assert got.shape == (FOOD_CROP, FOOD_CROP, 3)
                np.testing.assert_array_equal(got, want)


def test_food101_loader_batches_equal_jax(food_tree):
    for split, train in (("train", True), ("test", False)):
        kw = dict(crop_size=FOOD_CROP, batch_size=2, train=train, seed=3,
                  num_workers=3)
        ours = SRDataLoader(Food101Source(str(food_tree), split),
                            device="cpu", **kw)
        theirs = JaxLoader(JaxFood101(str(food_tree), split), **kw)
        got, want = _epochs(ours), _epochs(theirs)
        assert len(got[0]) == len(want[0]) == len(ours) > 0
        for ge, we in zip(got, want):
            for g, w in zip(ge, we):
                np.testing.assert_array_equal(g, w)


def test_load_sample_names_a_refused_file(food_tree, tmp_path):
    """JAX's loader falls back to PIL for a stream its libjpeg refuses; the
    port's raises naming the file and the feature, and the loader fails
    the epoch."""
    root = _food_tree(tmp_path, {"train": FOOD_TRAIN[:2]})
    src = Food101Source(str(root), "train")
    Image.open(src.paths[1]).convert("CMYK").save(src.paths[1])
    with pytest.raises(UnsupportedImage, match="CMYK") as e:
        load_sample(src, 1, FOOD_CROP, True, np.random.default_rng(0))
    assert src.paths[1] in str(e.value)
    loader = SRDataLoader(src, crop_size=FOOD_CROP, batch_size=2,
                          device="cpu", num_workers=2)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        list(loader)
    assert isinstance(info.value.__cause__, UnsupportedImage)


def _values(seed, n=24):
    """A noisy climb with plateaus and dips (PSNR-like, some repeats)."""
    rng = np.random.default_rng(seed)
    v = 20.0 + np.cumsum(rng.choice([0.0, 0.0, 1e-5, 0.3, -0.2], n))
    return [float(x) for x in v]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedules_equal_jax_and_torch(seed):
    values = _values(seed)
    ours, theirs = ReduceLROnPlateau(4e-4), JaxPlateau(4e-4)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=4e-4)
    ref = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, mode="max",
                                                     factor=0.5, patience=2)
    stop, jstop = EarlyStopping(patience=3), JaxStopper(patience=3)
    lrs = []
    for v in values:
        lr = ours.step(v)
        assert lr == theirs.step(v)
        ref.step(v)
        assert lr == opt.param_groups[0]["lr"]
        assert stop.update(v) == jstop.update(v)
        assert stop.should_stop == jstop.should_stop
        assert ours.state_dict() == theirs.state_dict()
        assert stop.state_dict() == jstop.state_dict()
        lrs.append(lr)
    assert lrs[-1] < lrs[0]  # the sequence decays at least once
    again = ReduceLROnPlateau(1.0)
    again.load_state_dict(ours.state_dict())
    assert again.state_dict() == ours.state_dict()
