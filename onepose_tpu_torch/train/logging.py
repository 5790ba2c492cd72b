"""Training metric logging: a JSONL file always (the record), TensorBoard
scalars when ``torch.utils.tensorboard`` can be imported, and a wandb
mirror when the ``wandb`` package is importable.

The port's copy of ``onepose_tpu/train/logging.py`` (the reference's
rank-0 TensorBoard logger and wandb callbacks); the optional imports stay
inside the functions that use them.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Optional


class WandbAdapter:
    """Optional wandb mirror of the reference's callbacks
    (wandb_callbacks.py): run init with config, metric logging, checkpoint
    artifact upload (UploadCheckpointsAsArtifact role), and finish. Every
    method is a no-op when ``wandb`` isn't importable, so callers never
    need to guard."""

    def __init__(self, project: Optional[str] = None,
                 config: Optional[dict] = None,
                 log_ckpts: bool = True):
        self.run = None
        self.log_ckpts = log_ckpts
        if project is None:
            return
        try:
            import wandb
        except ImportError:
            return
        self._wandb = wandb
        self.run = wandb.init(project=project, config=config or {})

    def log(self, step: int, metrics: Dict[str, float]):
        if self.run is not None:
            self.run.log(dict(metrics), step=step)

    def log_checkpoint(self, path: str):
        """UploadCheckpointsAsArtifact equivalent
        (wandb_callbacks.py:60-78)."""
        if self.run is None or not self.log_ckpts:
            return
        art = self._wandb.Artifact(
            f"ckpt-{self.run.id}", type="checkpoints")
        if osp.isdir(path):
            art.add_dir(path)
        else:
            art.add_file(path)
        self.run.log_artifact(art)

    def finish(self):
        if self.run is not None:
            self.run.finish()
            self.run = None


class MetricLogger:
    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 wandb_project: Optional[str] = None,
                 wandb_config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(osp.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        self.wandb = WandbAdapter(wandb_project, wandb_config)
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self.tb = SummaryWriter(osp.join(log_dir, "tb"))

    def log(self, step: int, metrics: Dict[str, float]):
        self.jsonl.write(json.dumps({"step": step, **metrics}) + "\n")
        self.jsonl.flush()
        self.wandb.log(step, metrics)
        if self.tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self.tb.add_scalar(k, v, global_step=step)
            self.tb.flush()

    def log_checkpoint(self, path: str):
        self.wandb.log_checkpoint(path)

    def close(self):
        self.jsonl.close()
        self.wandb.finish()
        if self.tb is not None:
            self.tb.close()
