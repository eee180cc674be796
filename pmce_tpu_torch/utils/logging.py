"""Metric logging: JSONL + optional wandb.

The port's own copy of ``pmce_tpu/utils/logging.py``, with the same JSONL
records and keys (the reference's wandb per-step loss terms and per-epoch
metrics, ``lib/core/base.py:111-169,250-259``). wandb is imported only when
asked for (off by default); when absent or failing, metrics still stream to
the JSONL file.
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, out_dir: str = "", use_wandb: bool = False,
                 project: str = "pmce-tpu", run_name: str = "run",
                 config: dict | None = None):
        self._jsonl = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self._jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=project, name=run_name,
                           config=config or {}, reinit=True)
            except ImportError:
                print("[pmce] wandb not installed; JSONL logging only")
            except Exception as e:  # auth/network/usage errors
                # Observability must degrade, not kill the run before
                # step 0: fall back to JSONL on ANY wandb.init failure.
                self._wandb = None
                print(f"[pmce] wandb.init failed ({e!r}); "
                      "JSONL logging only")

    def log(self, metrics: dict, step: int | None = None) -> None:
        record = {"time": time.time(), **metrics}
        if step is not None:
            record["step"] = step
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()
