"""Synthetic datasets for tests and the chip run (the port's copy of
``pyspark_tf_gke_tpu/data/synthetic.py``, numpy only): a CSV with the
health dataset's header and holes, the same at the reference's schema
and scale (``make_reference_csv``), a flat image dir + ``clean_labels.jsonl``
with a bright "laser spot" whose center is the regression target,
classification arrays and token batches. The same seed gives the same
bytes as the JAX package's generators: CSV text, PNG pixels and the
jsonl labels.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from pyspark_tf_gke_tpu_torch.utils.seeding import DEFAULT_SEED, np_rng

CSV_HEADER = (
    "edition,report_type,measure_name,state_name,subpopulation,value,lower_ci,upper_ci,source,source_date"
)

_MEASURES = ["Able-Bodied", "Asthma", "Cancer", "Child Poverty", "Premature Death"]
_SUBPOPS = ["Female", "Male", "Adults 18-44", "Adults 45-64", "Seniors 65+"]
_STATES = ["Alabama", "California", "New York", "Texas", "Utah"]


def make_synthetic_csv(path: str, rows: int = 500, missing_rate: float = 0.05,
                       seed: int = DEFAULT_SEED) -> str:
    rng = np_rng(seed)
    lines = [CSV_HEADER]
    for _ in range(rows):
        measure = _MEASURES[rng.integers(len(_MEASURES))]
        sub = _SUBPOPS[rng.integers(len(_SUBPOPS))]
        state = _STATES[rng.integers(len(_STATES))]
        value = rng.uniform(0, 100)
        lower, upper = value - rng.uniform(0, 5), value + rng.uniform(0, 5)
        fields = ["2023", "Annual", measure, state, sub,
                  f"{value:.2f}", f"{lower:.2f}", f"{upper:.2f}", "synthetic", "2023-01-01"]
        if rng.random() < missing_rate:  # reproduce the reference data's holes
            col = 4 + int(rng.integers(4))
            fields[col] = "" if rng.random() < 0.5 else "nan"
        lines.append(",".join(fields))
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def make_reference_csv(path: str, rows: int = 18154,
                       seed: int = DEFAULT_SEED) -> str:
    """A ``health_disparities`` dataset at the reference's schema and
    scale (its checked-in CSV has 18,154 rows): constant ``edition`` and
    ``report_type``; 30 measures, 52 states, 16 subpopulations with the
    EMPTY one the most common (~8%); ``value`` empty on ~7% of rows and
    the CIs empty together on slightly more; two dominant ``source``
    strings containing commas, so a parser must honour quoting; year-range
    ``source_date``s. The values are synthetic; the schema, cardinalities
    and hole rates are the contract.
    """
    rng = np_rng(seed)
    measures = [f"Measure {i:02d}" for i in range(28)] + [
        "Able-Bodied", "Premature Death"]  # a couple of realistic names
    states = [f"State {i:02d}" for i in range(51)] + ["United States"]
    subpops = [""] + [f"Subpop {i:02d}" for i in range(15)]
    # empty subpop most common, like the reference profile
    subpop_p = np.asarray([0.083] + [0.917 / 15] * 15)
    sources = [
        "Agency A, Survey of Record",          # comma → forced quoting
        "Bureau B, Community Survey PUMS",     # comma → forced quoting
        "Registry C",
        "Panel D Study",
        "Source E", "Source F", "Source G", "Source H", "Source I", "",
    ]
    source_p = np.asarray(
        [0.56, 0.30, 0.05, 0.03, 0.02, 0.015, 0.012, 0.008, 0.0045, 0.0005])
    dates = ["2017-2019", "2015-2019", "2019", "2018-2019", "2016-2018",
             "2020"]
    date_p = np.asarray([0.56, 0.37, 0.03, 0.02, 0.015, 0.005])

    import csv

    with open(path, "w", encoding="utf-8", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["edition", "report_type", "measure_name", "state_name",
                    "subpopulation", "value", "lower_ci", "upper_ci",
                    "source", "source_date"])
        for _ in range(rows):
            value = rng.uniform(0, 120)
            spread = rng.uniform(0.2, 8.0)
            cells_value = f"{value:.1f}"
            cells_lo = f"{max(value - spread, 0.0):.1f}"
            cells_hi = f"{value + spread:.1f}"
            r = rng.random()
            if r < 0.071:        # value AND CIs missing
                cells_value = cells_lo = cells_hi = ""
            elif r < 0.074:      # CIs missing, value present
                cells_lo = cells_hi = ""
            w.writerow([
                "2021", "2021 Health Disparities",
                measures[rng.integers(len(measures))],
                states[rng.integers(len(states))],
                subpops[rng.choice(len(subpops), p=subpop_p)],
                cells_value, cells_lo, cells_hi,
                sources[rng.choice(len(sources), p=source_p)],
                dates[rng.choice(len(dates), p=date_p)],
            ])
    return path


def make_synthetic_image_dataset(
    data_dir: str,
    num_images: int = 32,
    height: int = 64,
    width: int = 80,
    seed: int = DEFAULT_SEED,
) -> str:
    """Flat dir of PNGs + clean_labels.jsonl, laser-spot style: dark frame
    with a bright gaussian blob at the (x_px, y_px) target."""
    from PIL import Image

    os.makedirs(data_dir, exist_ok=True)
    rng = np_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    lines = []
    for i in range(num_images):
        cx = float(rng.uniform(4, width - 4))
        cy = float(rng.uniform(4, height - 4))
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 3.0 ** 2)))
        img = (blob[..., None] * np.array([255, 40, 40]) +
               rng.normal(8, 4, (height, width, 3))).clip(0, 255).astype(np.uint8)
        name = f"img_{i:04d}.png"
        Image.fromarray(img).save(os.path.join(data_dir, name))
        lines.append(json.dumps({
            "image": name,
            "point": {"x_px": cx, "y_px": cy},
            "image_size": {"width": width, "height": height},
        }))
    with open(os.path.join(data_dir, "clean_labels.jsonl"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines) + "\n")
    return data_dir


def synthetic_classification_arrays(
    n: int = 512, input_dim: int = 3, num_classes: int = 10, seed: int = DEFAULT_SEED
) -> Tuple[np.ndarray, np.ndarray]:
    """Linearly-separable-ish float features + int labels (MLP/CSV path)."""
    rng = np_rng(seed)
    centers = rng.normal(0, 3, (num_classes, input_dim))
    y = rng.integers(0, num_classes, n).astype(np.int32)
    x = centers[y] + rng.normal(0, 1, (n, input_dim))
    return x.astype(np.float32), y


def synthetic_tokens(
    batch: int = 8, seq_len: int = 128, vocab_size: int = 30522, seed: int = DEFAULT_SEED
) -> Dict[str, np.ndarray]:
    rng = np_rng(seed)
    return {
        "input_ids": rng.integers(0, vocab_size, (batch, seq_len)).astype(np.int32),
        "attention_mask": np.ones((batch, seq_len), dtype=np.int32),
        "labels": rng.integers(0, 2, (batch,)).astype(np.int32),
    }
