"""The port's train() with loss_function="perceptual" (the supervised
step on the VGG19 loss) against the JAX package's train() at lr 0 from
shared weights, on the CPU: test_torch_gan_loop.py's parity, in a file of
its own so that each file's run stays short."""
from test_torch_gan_loop import lr0_parity, narrow_nets, weights  # noqa: F401
from torch_threads import one_thread  # noqa: F401


def test_perceptual_loop_matches_jax_train_at_lr0(tmp_path, weights,  # noqa: F811
                                                  monkeypatch):
    lr0_parity("perceptual", tmp_path, weights, monkeypatch)
