"""Image data path (the port's copy of
``pyspark_tf_gke_tpu/data/images.py``): a flat directory and
``clean_labels.jsonl`` with (x_px, y_px) regression targets, with the
reference loader's semantics:

* a jsonl line is used only if it parses, names a file that exists with
  a supported extension, and has both ``point.x_px`` and ``point.y_px``;
* images decode to RGB with PIL, resize with ``tf.image.resize``'s
  bilinear numerics (half-pixel centres, no antialias:
  :func:`resize_bilinear_tf`) and scale to [0, 1] float32;
* targets are pixel coordinates, not normalised.

Decoding runs on the host in a thread pool (PIL's decode and the numpy
resize release the GIL), in order; the trainer stages the batches to the
device (``data/pipeline.py``).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

SUPPORTED_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".ppm"}


def list_labeled_images(data_dir: str) -> Tuple[List[str], np.ndarray]:
    """Parse clean_labels.jsonl → (absolute file paths, [N,2] float32 targets)."""
    labels_path = os.path.join(data_dir, "clean_labels.jsonl")
    if not os.path.isfile(labels_path):
        raise RuntimeError(f"clean_labels.jsonl not found in: {data_dir}")

    filepaths: List[str] = []
    targets: List[List[float]] = []
    with open(labels_path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            name = str(obj.get("image", "")).strip()
            if not name:
                continue
            _, ext = os.path.splitext(name.lower())
            if ext not in SUPPORTED_EXTS:
                continue
            full_path = os.path.join(data_dir, name)
            if not os.path.isfile(full_path):
                continue
            point = obj.get("point") or {}
            x_px, y_px = point.get("x_px"), point.get("y_px")
            if x_px is None or y_px is None:
                continue
            filepaths.append(full_path)
            targets.append([float(x_px), float(y_px)])

    if not filepaths:
        raise RuntimeError(
            "No valid labeled images were parsed from clean_labels.jsonl")
    return filepaths, np.asarray(targets, dtype=np.float32)


def count_images(data_dir: str) -> int:
    """Count the usable labeled images."""
    return len(list_labeled_images(data_dir)[0])


def resize_bilinear_tf(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``tf.image.resize(method='bilinear')`` in numpy: half-pixel
    centres, no antialiasing (PIL's BILINEAR antialiases on downscale).
    A separable lerp: the fractional weight comes from the unclamped
    floor, the sample indices are clamped into range."""
    img = img.astype(np.float32)
    in_h, in_w = img.shape[:2]

    def axis(n_in: int, n_out: int):
        if n_in == n_out:
            return None
        scale = n_in / n_out
        src = (np.arange(n_out, dtype=np.float32) + 0.5) * scale - 0.5
        lo_f = np.floor(src)
        frac = (src - lo_f).astype(np.float32)
        lo = np.clip(lo_f.astype(np.int64), 0, n_in - 1)
        hi = np.clip(lo_f.astype(np.int64) + 1, 0, n_in - 1)
        return lo, hi, frac

    rows = axis(in_h, height)
    if rows is not None:
        lo, hi, fr = rows
        img = img[lo] * (1.0 - fr)[:, None, None] + img[hi] * fr[:, None, None]
    cols = axis(in_w, width)
    if cols is not None:
        lo, hi, fr = cols
        img = img[:, lo] * (1.0 - fr)[None, :, None] + img[:, hi] * fr[None, :, None]
    return img


def load_image(path: str, height: int, width: int) -> np.ndarray:
    """Decode → RGB → TF-semantics bilinear resize → [0,1] float32."""
    from PIL import Image

    with Image.open(path) as img:
        arr = np.asarray(img.convert("RGB"), dtype=np.float32)
    return resize_bilinear_tf(arr, height, width) / 255.0


def make_image_arrays(
    data_dir: str,
    image_size: Tuple[int, int],
    indices: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Materialise (images [N,H,W,3], targets [N,2]) for a subset of the
    dataset, decoded in a thread pool in input order (the result equals
    the serial loop's)."""
    filepaths, targets = list_labeled_images(data_dir)
    if indices is not None:
        filepaths = [filepaths[i] for i in indices]
        targets = targets[indices]
    h, w = image_size
    workers = min(32, os.cpu_count() or 4, max(len(filepaths), 1))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        images = np.stack(list(ex.map(
            lambda p: load_image(p, h, w), filepaths)))
    return images, targets
