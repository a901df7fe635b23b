"""Visual evaluation of a trained CNN regressor (counterpart of
``pyspark_tf_gke_tpu/evaluate/image_checker.py``, the reference's
``ManualImageChecker``): load the parameters of the latest checkpoint
the port's training CLI wrote (``train/checkpoint.py``), predict the
(x, y) spot for every labelled image of a directory, save an overlay
plot of each, and report the mean and max pixel error.

    python -m pyspark_tf_gke_tpu_torch.evaluate.image_checker \\
        --checkpoint-dir RUN/checkpoints --data-dir IMAGES [--flat-layer] \\
        [--device cpu] [--no-plots]

The plots need matplotlib (imported when the first one is drawn);
``--no-plots`` (``main(data_dir, plots=False)``) reports the errors
without it. The model computes in f32, as the JAX checker's does.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.data.images import (list_labeled_images,
                                                  load_image)
from pyspark_tf_gke_tpu_torch.models.cnn import CNNRegressor
from pyspark_tf_gke_tpu_torch.train.checkpoint import CheckpointManager
from pyspark_tf_gke_tpu_torch.utils.logging import get_logger

logger = get_logger("evaluate.image_checker")


class ManualImageChecker:
    def __init__(
        self,
        checkpoint_dir: str,
        image_size: Tuple[int, int] = (256, 320),
        flat: bool = False,
        output_dir: str = "./eval-plots",
        device: Union[str, torch.device] = "cuda",
    ):
        self.image_size = image_size
        self.output_dir = output_dir
        self.model = CNNRegressor(num_outputs=2, flat=flat,
                                  image_size=image_size, device=device)
        self.device = next(self.model.parameters()).device
        step, saved = CheckpointManager(checkpoint_dir).read()
        self.model.load_state_dict(saved["params"])
        logger.info("loaded checkpoint step %s", step)

    @torch.no_grad()
    def predict(self, image: np.ndarray) -> Tuple[float, float]:
        """The model's (x, y) for one ``[H, W, 3]`` image."""
        x = torch.from_numpy(np.ascontiguousarray(image[None])).to(
            self.device)
        out = self.model(x)[0].cpu()
        return float(out[0]), float(out[1])

    def img_to_plot(self, image: np.ndarray, pred: Tuple[float, float],
                    target: Optional[Tuple[float, float]],
                    out_path: str) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.imshow(image)
        ax.plot(pred[0], pred[1], "rx", markersize=12, markeredgewidth=3,
                label=f"pred ({pred[0]:.1f}, {pred[1]:.1f})")
        if target is not None:
            ax.plot(target[0], target[1], "g+", markersize=12,
                    markeredgewidth=3,
                    label=f"true ({target[0]:.1f}, {target[1]:.1f})")
        ax.legend(loc="upper right")
        ax.set_axis_off()
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)

    def main(self, data_dir: str, plots: bool = True) -> dict:
        """Predict every labelled image (and plot it, with ``plots``);
        returns the count and the mean and max pixel error."""
        filepaths, targets = list_labeled_images(data_dir)
        if plots:
            os.makedirs(self.output_dir, exist_ok=True)
        errors = []
        for path, target in zip(filepaths, targets):
            image = load_image(path, *self.image_size)
            pred = self.predict(image)
            if plots:
                name = os.path.splitext(os.path.basename(path))[0]
                self.img_to_plot(image, pred, tuple(target), os.path.join(
                    self.output_dir, f"{name}_eval.png"))
            errors.append(np.hypot(pred[0] - target[0], pred[1] - target[1]))
        result = {
            "n_images": len(filepaths),
            "mean_px_error": float(np.mean(errors)),
            "max_px_error": float(np.max(errors)),
            "plots_dir": self.output_dir if plots else None,
        }
        logger.info("eval: %s", result)
        return result


def cli(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--img-height", type=int, default=256)
    p.add_argument("--img-width", type=int, default=320)
    p.add_argument("--flat-layer", action="store_true")
    p.add_argument("--output-dir", default="./eval-plots")
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plots", action="store_true",
                   help="report the errors without drawing (no matplotlib)")
    a = p.parse_args(argv)
    result = ManualImageChecker(
        a.checkpoint_dir, (a.img_height, a.img_width), a.flat_layer,
        a.output_dir, a.device).main(a.data_dir, plots=not a.no_plots)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    cli()
