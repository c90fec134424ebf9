"""The port's packed weights file (``training/packed.py``, ``.f101w``):
the re-packed winners unpack bit for bit to the JAX package's export of
their Orbax checkpoints (ResNetSR's running stats and 0-d counters kept);
the AttentionSR fine-tunes, stored as bfloat16 deltas against the
AttentionSR winner, unpack to exactly the round-to-nearest-even bfloat16
of theirs, widened; ``load_checkpoint`` reads torch files and packs alike;
a cut, altered or unknown file and a missing or different base raise."""
import hashlib
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401

from food101_sr_tpu.training import load_checkpoint as jax_load_checkpoint
from food101_sr_tpu_torch.training import load_checkpoint
from food101_sr_tpu_torch.training.packed import (MAGIC, PackError,
                                                  bf16_bits,
                                                  pack_state_dict,
                                                  read_index,
                                                  unpack_state_dict,
                                                  widen_bf16)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from tools.export_sr_checkpoint import export_state_dict  # noqa: E402

ASSETS = ROOT / "food101_sr_tpu_torch" / "assets"
WEIGHTS = ROOT / "weights"
# pack -> (Orbax checkpoint, architecture, base pack or None)
PACKS = {"winner_attentionsr": ("winner_attentionsr_best", "AttentionSR",
                                None),
         "winner_resnet": ("winner_resnet_best", "RESNET", None),
         "winner_resnet_qat": ("winner_resnet_qat_best", "RESNET", None),
         "winner_attentionsr_gan": ("winner_attentionsr_gan_best",
                                    "AttentionSR", "winner_attentionsr"),
         "winner_attentionsr_qat": ("winner_attentionsr_qat_best",
                                    "AttentionSR", "winner_attentionsr")}


def _export(name):
    ckpt, arch, _ = PACKS[name]
    sd, got = export_state_dict(jax_load_checkpoint(str(WEIGHTS / ckpt)))
    assert got == arch
    return sd


@pytest.mark.parametrize("name", [n for n, v in PACKS.items()
                                  if v[2] is None])
def test_repacked_winner_is_bit_equal_to_the_jax_export(name):
    got = unpack_state_dict(str(ASSETS / f"{name}.f101w"))
    want = _export(name)
    assert list(got) == list(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].shape == v.shape, k  # num_batches_tracked stays 0-d
        assert got[k].dtype == (torch.float32 if v.dtype.kind == "f"
                                else torch.from_numpy(v).dtype), k
        assert got[k].numpy().tobytes() == np.ascontiguousarray(
            v).tobytes(), k
    assert read_index(str(ASSETS / f"{name}.f101w"))["base"] is None
    if PACKS[name][1] == "RESNET":
        assert sum(k.endswith("num_batches_tracked") for k in got) == 33
        assert sum(k.endswith(("running_mean", "running_var"))
                   for k in got) == 66


@pytest.mark.parametrize("name", [n for n, v in PACKS.items() if v[2]])
def test_tune_pack_is_the_rne_bfloat16_of_its_weights(name):
    path = ASSETS / f"{name}.f101w"
    got = unpack_state_dict(str(path))
    want = _export(name)
    assert list(got) == list(want)
    for k, v in want.items():
        rne = torch.from_numpy(np.asarray(v, np.float32)).to(
            torch.bfloat16).to(torch.float32)
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], rne), k
    index = read_index(str(path))
    base = ASSETS / f"{PACKS[name][2]}.f101w"
    assert index["base"]["file"] == base.name
    assert {e["stored"] for e in index["tensors"]} == {"bfloat16"}
    # the base's digest is that of its decoded tensors
    h = hashlib.sha256()
    for v in unpack_state_dict(str(base)).values():
        h.update(v.numpy().tobytes())
    assert index["base"]["sha256"] == h.hexdigest()


def test_bf16_bits_round_to_nearest_even_as_torch():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        # ties (low half exactly 0x8000) on both sides of even, the largest
        # finite (rounds to infinity), subnormals, signed zeros, infinities
        np.array([0x3F808000, 0x3F818000, 0x7F7FFFFF, 0x00000001,
                  0x807FFFFF, 0x80000000, 0x00000000, 0x7F800000,
                  0xFF800000], np.uint32).view(np.float32)])
    nan = np.array([0x7F800001, 0xFFFFFFFF], np.uint32).view(np.float32)
    assert np.isnan(widen_bf16(bf16_bits(nan))).all()  # not infinities
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    assert np.array_equal(bf16_bits(x), want.view(np.uint16))
    assert np.array_equal(widen_bf16(bf16_bits(x)), torch.from_numpy(x).to(
        torch.bfloat16).to(torch.float32).numpy())


def _sd(seed):
    g = torch.Generator().manual_seed(seed)
    return {"conv.weight": torch.randn(8, 3, 3, 3, generator=g),
            "conv.bias": torch.randn(8, generator=g),
            "bn.running_var": torch.rand(8, generator=g),
            "bn.num_batches_tracked": torch.tensor(17)}


def test_load_checkpoint_reads_torch_files_and_packs_alike(tmp_path):
    sd = _sd(0)
    torch.save(sd, tmp_path / "w.pth")
    pack_state_dict(sd, str(tmp_path / "w.f101w"))
    assert (tmp_path / "w.f101w").read_bytes()[:len(MAGIC)] == MAGIC
    a = load_checkpoint(str(tmp_path / "w.pth"))
    b = load_checkpoint(str(tmp_path / "w.f101w"))
    assert list(a) == list(b) == list(sd)
    for k in sd:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def _packs(tmp_path):
    """A base pack and a bfloat16 delta against it, in tmp_path."""
    base = pack_state_dict(_sd(0), str(tmp_path / "base.f101w"))
    tuned = {k: v + 0.01 if v.is_floating_point() else v
             for k, v in _sd(0).items()}
    delta = pack_state_dict(tuned, str(tmp_path / "tune.f101w"), base=base,
                            dtype="bfloat16")
    return base, delta, tuned


def test_a_delta_unpacks_to_its_rounded_weights(tmp_path):
    _, delta, tuned = _packs(tmp_path)
    got = unpack_state_dict(delta)
    for k, v in tuned.items():
        want = v.to(torch.bfloat16).to(torch.float32) \
            if v.is_floating_point() else v
        assert torch.equal(got[k], want), k


def _cut(path):
    data = Path(path).read_bytes()
    Path(path).write_bytes(data[:len(data) - 100])


def _flip(path):
    data = bytearray(Path(path).read_bytes())
    data[len(data) // 2] ^= 0x04
    Path(path).write_bytes(bytes(data))


def _magic(path):
    data = Path(path).read_bytes()
    Path(path).write_bytes(b"F101W\x00\x02\n" + data[len(MAGIC):])


def _no_base(path):
    os.remove(Path(path).parent / "base.f101w")


def _other_base(path):
    d = Path(path).parent
    shutil.copy(d / "base.f101w", d / "keep.f101w")
    pack_state_dict(_sd(1), str(d / "base.f101w"))


@pytest.mark.parametrize("fault, which, reason", [
    (_cut, "base", "truncated"), (_cut, "tune", "truncated"),
    (_flip, "base", "altered"), (_flip, "tune", "altered"),
    (_magic, "base", "unknown magic"), (_no_base, "tune", "missing"),
    (_other_base, "tune", "decodes to sha256")])
def test_faults_raise_with_the_reason(tmp_path, fault, which, reason):
    base, delta, _ = _packs(tmp_path)
    path = base if which == "base" else delta
    fault(path)
    with pytest.raises(PackError, match=reason):
        unpack_state_dict(path)
    if fault is not _magic:  # a file without the magic is a torch file
        with pytest.raises(PackError, match=reason):
            load_checkpoint(path)
