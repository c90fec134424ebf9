"""Host-side training control: ReduceLROnPlateau and early stopping
(counterpart of ``food101_sr_tpu/training/schedule.py``, the same rules
and the same ``state_dict`` keys). The learning rate reaches the fused
optimizer through ``SRTrainState.set_learning_rate``; nothing is rebuilt.
"""
from __future__ import annotations


class ReduceLROnPlateau:
    """torch ``ReduceLROnPlateau(mode='max', factor=0.5, patience=2)``
    semantics (defaults: rel threshold 1e-4, cooldown 0, min_lr 0)."""

    def __init__(self, lr: float, mode: str = "max", factor: float = 0.5,
                 patience: int = 2, threshold: float = 1e-4, min_lr: float = 0.0):
        if mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max' or 'min', got {mode!r}")
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("-inf") if mode == "max" else float("inf")
        self.num_bad = 0

    def _is_better(self, value: float) -> bool:
        # torch's rel-threshold rule, verbatim (no sign special-casing).
        if self.mode == "max":
            return value > self.best * (1.0 + self.threshold)
        return value < self.best * (1.0 - self.threshold)

    def step(self, value: float) -> float:
        """Feed the epoch metric; returns the (possibly decayed) lr."""
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, state: dict):
        self.lr = float(state["lr"])
        self.best = float(state["best"])
        self.num_bad = int(state["num_bad"])


class EarlyStopping:
    """Best-metric patience counter."""

    def __init__(self, patience: int = 5):
        self.patience = patience
        self.best = float("-inf")
        self.counter = 0

    def update(self, value: float) -> bool:
        """Returns True when this value is a new best."""
        if value > self.best:
            self.best = value
            self.counter = 0
            return True
        self.counter += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.counter >= self.patience

    def state_dict(self) -> dict:
        return {"best": self.best, "counter": self.counter}

    def load_state_dict(self, state: dict):
        self.best = float(state["best"])
        self.counter = int(state["counter"])
