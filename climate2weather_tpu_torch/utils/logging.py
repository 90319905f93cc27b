"""Run logging (own copy of climate2weather_tpu/utils/logging.py):
``<run_dir>/metrics.jsonl`` gets one JSON object per log call; images go to
``<run_dir>/media/``; W&B is used when importable and asked for. PIL and
wandb are imported only where an image or W&B is used, and neither is
needed."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np


class RunLogger:
    def __init__(self, run_dir: str, enabled: bool = True, use_wandb: bool = False,
                 run_id: Optional[str] = None, config: Optional[dict] = None,
                 rank: int = 0):
        self.enabled = enabled
        self.run_dir = run_dir
        self.rank = rank
        suffix = "" if rank == 0 else f"-rank{rank}"
        self.path = os.path.join(run_dir, f"metrics{suffix}.jsonl")
        self._media_suffix = suffix
        self._wandb = None
        if enabled and use_wandb:
            try:
                import wandb  # type: ignore

                project = os.environ.get("WANDB_PROJECT_NAME")
                if project is None:
                    raise RuntimeError("W&B logging requested but WANDB_PROJECT_NAME is not set")
                self._wandb = wandb.init(project=project, id=run_id, config=config,
                                         resume="allow")
                self._wandb.define_metric("train/kdata")
                self._wandb.define_metric("train/*", step_metric="train/kdata")
            except ImportError:
                print("wandb not installed; logging to JSONL only")

    def log(self, metrics: dict) -> None:
        if not self.enabled:
            return
        rec = dict(metrics)
        rec["_time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics)

    def log_image(self, name: str, array, kdata: int) -> None:
        """Save an image under <run_dir>/media/ (a .npy where PIL is absent)."""
        if not self.enabled:
            return
        media = os.path.join(self.run_dir, "media")
        os.makedirs(media, exist_ok=True)
        arr = np.asarray(array)
        lo, hi = np.nanmin(arr), np.nanmax(arr)
        norm = (arr - lo) / max(hi - lo, 1e-12)
        img8 = (np.clip(norm, 0, 1) * 255).astype(np.uint8)
        fname = f"{name}-{kdata:07d}{self._media_suffix}"
        try:
            from PIL import Image

            Image.fromarray(img8).save(os.path.join(media, f"{fname}.png"))
        except ImportError:
            np.save(os.path.join(media, f"{fname}.npy"), arr)
        if self._wandb is not None:
            import wandb  # type: ignore

            self._wandb.log({name: wandb.Image(img8), "train/kdata": kdata})

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def value_histogram_image(values, bins: int = 80, height: int = 100, width: int = 3) -> np.ndarray:
    """Histogram of the finite sample values as a grayscale [height,
    bins * width] image drawn with numpy: one bar per bin, its height the
    bin's count over the largest count."""
    vals = np.asarray(values).ravel()
    finite = vals[np.isfinite(vals)]
    img = np.zeros((height, bins * width), np.float32)
    if finite.size:
        counts, _ = np.histogram(finite, bins=bins)
        tops = np.round(counts / max(counts.max(), 1) * height).astype(int)
        for i, top in enumerate(tops):
            img[height - top:, i * width:(i + 1) * width] = 1.0
    return img


def trajectory_to_imgrid(traj):
    """[L, H, W, C] trajectory -> [L*H, C*W] grid (time down, features
    across)."""
    t = np.asarray(traj)
    L, H, W, C = t.shape
    return t.transpose(0, 1, 3, 2).reshape(L * H, C * W)
