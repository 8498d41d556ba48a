"""Shared CLI plumbing (counterpart of vipformer_tpu/cli/common.py:setup):
the run directory, its log and its metrics stream. The port runs on one
card, so there is no mesh and the batch needs no rounding."""

from __future__ import annotations

import dataclasses
import datetime
import json
import os

from vipformer_tpu_torch.config import Config


class Run:
    """The run directory `<run_dir>/<proj_name>/<exp_name>` with the resolved
    `config.json`, a log file beside stdout, and metrics.jsonl."""

    def __init__(self, cfg: Config):
        self.root = os.path.join(cfg.run_dir, cfg.proj_name, cfg.exp_name)
        os.makedirs(os.path.join(self.root, "models"), exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        self.log_path = os.path.join(self.root, f"{stamp}.log") if cfg.log_to_file else None
        with open(os.path.join(self.root, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

    def model_path(self, name: str) -> str:
        return os.path.join(self.root, "models", name + ".ckpt")

    def write(self, msg: str) -> None:
        line = f"{datetime.datetime.now():%Y-%m-%d %H:%M:%S} {msg}"
        print(line, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(line + "\n")

    def metrics(self, step: int, **kv) -> None:
        with open(os.path.join(self.root, "metrics.jsonl"), "a") as f:
            f.write(json.dumps({"step": step, **kv}) + "\n")
