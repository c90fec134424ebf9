"""Run logging: W&B when available, JSONL fallback otherwise (counterpart
of ``food101_sr_tpu/utils/logging.py``).

The key names are the reference's (per-step train_loss + dynamics/*,
per-epoch val_psnr/val_loss/lr, final test_* keys, checkpoint uploads),
so dashboards carry over; without wandb the run is a local JSONL file,
``<FOOD101_SR_RUN_DIR or runs>/<name>/log.jsonl``. In a multi-process
run only rank 0 owns the run record (every rank runs the same loop on the
same state, so rank 0's log is the run; each rank appending would double
every row).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping, Optional

from ..parallel.distributed import rank

try:  # wandb is an optional dependency
    import wandb as _wandb
except ImportError:  # pragma: no cover - exercised only where wandb exists
    _wandb = None


class RunLogger:
    def __init__(self, config: Mapping[str, Any], name: Optional[str] = None,
                 use_wandb: Optional[bool] = None,
                 run_dir: Optional[str] = None):
        if run_dir is None:  # FOOD101_SR_RUN_DIR reroutes logs (tests -> tmp)
            run_dir = os.environ.get("FOOD101_SR_RUN_DIR", "runs")
        self.config = dict(config)
        self.primary = rank() == 0
        use_wandb = (_wandb is not None) if use_wandb is None else use_wandb
        use_wandb = use_wandb and self.primary
        self._wandb_run = None
        if use_wandb and _wandb is not None:
            self._wandb_run = _wandb.init(config=self.config, name=name)
            # sweep agents override config keys through wandb.init
            self.config = dict(self._wandb_run.config)
        self._fh = None
        if self._wandb_run is None and self.primary:
            name = name or f"run_{int(time.time())}"
            path = os.path.join(run_dir, name)
            os.makedirs(path, exist_ok=True)
            self._fh = open(os.path.join(path, "log.jsonl"), "a")
            self._fh.write(json.dumps({"_config": self.config}) + "\n")
            self._fh.flush()

    def log(self, data: Mapping[str, Any]):
        if self._wandb_run is not None:
            self._wandb_run.log(dict(data))
        elif self._fh is not None:
            self._fh.write(json.dumps({k: _jsonable(v) for k, v in data.items()}) + "\n")
            self._fh.flush()

    def save(self, path: str):
        """Checkpoint-artifact upload (the reference calls wandb.save after
        each best checkpoint); a record in the local log otherwise."""
        if self._wandb_run is not None:
            self._wandb_run.save(path)
        else:
            self.log({"_artifact": path})

    def finish(self):
        if self._wandb_run is not None:
            self._wandb_run.finish()
        elif self._fh is not None:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)
