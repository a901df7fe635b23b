"""The port's serving bundle and the weight converter (counterpart of
``pyspark_tf_gke_tpu/train/export.py``).

A bundle is a directory holding

* ``config.json`` — the JAX bundle's schema (``format``, ``model``,
  ``quantized``, ``quantized_paths``, ``quantized_scale_shapes``,
  ``tokenizer``, ``config`` with the ``CausalLMConfig`` fields and the
  dtype by name), with this package's own ``format`` string;
* ``params.pt`` — a flat dict of tensors keyed by flax path
  (``layer_3/attention/query/kernel``); an int8 leaf is stored as
  ``…/q`` (int8) and ``…/scale`` (f32). Read with
  ``torch.load(weights_only=True)``: no pickled code.

Dense kernels keep the flax layout ``[in, out]`` and the model computes
``x @ kernel`` (``models/layers.Dense``), so no transpose happens
anywhere. An orbax bundle of the JAX package is converted by a caller
that has JAX: ``load_serving_bundle`` -> ``jax.device_get`` ->
:func:`params_from_flax` -> :func:`export_serving_bundle` (README,
"PyTorch/H100 port"). The port itself never reads orbax.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections.abc import Mapping
from typing import Optional, Tuple, Union

import numpy as np
import torch

from pyspark_tf_gke_tpu_torch.device import resolve_device
from pyspark_tf_gke_tpu_torch.models.causal_lm import (CausalLM,
                                                       CausalLMConfig,
                                                       require_flash)
from pyspark_tf_gke_tpu_torch.ops.quant import (Params, QTensor, is_quantized,
                                                quantize_tree)

FORMAT = "pyspark_tf_gke_tpu_torch.serving_bundle.v1"
# the dtypes the kernels are built and checked for (float16 waits for a
# slice that needs it: ROADMAP, PyTorch/H100 port)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _unsupported_dtype(name) -> NotImplementedError:
    return NotImplementedError(
        f"bundle dtype {name} is not ported (the kernels take "
        f"{sorted(_DTYPES)}); float16 is queued in ROADMAP")


def config_to_dict(cfg: CausalLMConfig) -> dict:
    if cfg.dtype not in _DTYPE_NAMES:
        raise _unsupported_dtype(cfg.dtype)
    out = dataclasses.asdict(cfg)
    out["dtype"] = _DTYPE_NAMES[cfg.dtype]
    return out


def config_from_dict(fields: dict) -> CausalLMConfig:
    """``CausalLMConfig`` from a ``config.json`` ``config`` block (the
    JAX bundle's and this package's share one schema)."""
    fields = dict(fields)
    if fields["dtype"] not in _DTYPES:
        raise _unsupported_dtype(fields["dtype"])
    fields["dtype"] = _DTYPES[fields["dtype"]]
    return CausalLMConfig(**fields)


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def params_from_flax(tree: Mapping) -> Params:
    """Carry the JAX package's parameters, as host numpy arrays, into
    the port. ``tree`` is the flax param tree (nested mappings) or a flat
    dict keyed by flax path. A leaf is an array, a ``(q, scale)`` pair,
    or an object with ``q`` and ``scale`` attributes (the JAX
    ``QTensor`` after ``jax.device_get``); the pairs become the port's
    :class:`QTensor`. Layouts are kept as flax has them."""
    params: Params = {}
    for path, leaf in _flatten(tree).items():
        if isinstance(leaf, tuple):
            q, scale = leaf
        elif hasattr(leaf, "q") and hasattr(leaf, "scale"):
            q, scale = leaf.q, leaf.scale
        else:
            params[path] = torch.from_numpy(np.array(leaf, dtype=np.float32))
            continue
        params[path] = QTensor(torch.from_numpy(np.array(q, dtype=np.int8)),
                               torch.from_numpy(np.array(scale,
                                                         dtype=np.float32)),
                               torch.float32)
    return params


def export_serving_bundle(cfg: CausalLMConfig, params: Params, out_dir: str,
                          quantize: bool = True, tokenizer_spec: str = "byte",
                          quantize_min_size: int = 4096,
                          extra_meta: Optional[dict] = None) -> str:
    """Write a bundle (int8 weights by default, as the JAX exporter).
    Returns ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    if quantize and not is_quantized(params):
        params = quantize_tree(params, min_size=quantize_min_size)
    qpaths = sorted(p for p, leaf in params.items()
                    if isinstance(leaf, QTensor))
    meta = {
        **(extra_meta or {}),
        "format": FORMAT,
        "model": "causal_lm",
        "quantized": bool(qpaths),
        "quantized_paths": qpaths,
        "quantized_scale_shapes": {p: list(params[p].scale.shape)
                                   for p in qpaths},
        "tokenizer": tokenizer_spec,
        "config": config_to_dict(cfg),
    }
    tensors = {}
    for path, leaf in params.items():
        if isinstance(leaf, QTensor):
            tensors[f"{path}/q"] = leaf.q.detach().cpu().contiguous()
            tensors[f"{path}/scale"] = leaf.scale.detach().cpu().contiguous()
        else:
            tensors[path] = leaf.detach().cpu().contiguous()
    torch.save(tensors, os.path.join(out_dir, "params.pt"))
    with open(os.path.join(out_dir, "config.json"), "w") as fh:
        json.dump(meta, fh, indent=2)
    return out_dir


def load_serving_bundle(bundle_dir: str,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Tuple[CausalLM, Params, dict]:
    """``(model, params, meta)``: the model on ``device``, the bundle's
    parameter tree as stored (host tensors, QTensor leaves kept), and
    ``config.json``. An int8 bundle's quantized leaves stay int8 on the
    device with their f32 scales, as the JAX package keeps them at rest:
    the Dense kernels stream through K6 in the decode loops and the
    embedding tables gather int8 rows (``models/layers.py``); no float
    copy of a quantized path is made."""
    device = resolve_device(device)
    with open(os.path.join(bundle_dir, "config.json")) as fh:
        meta = json.load(fh)
    if meta.get("model") != "causal_lm":
        raise ValueError(f"unsupported bundle model {meta.get('model')!r}")
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"bundle format {meta.get('format')!r} is not {FORMAT!r}; "
            "convert a JAX bundle with params_from_flax + "
            "export_serving_bundle (README, 'PyTorch/H100 port')")
    cfg = config_from_dict(meta["config"])
    require_flash(cfg, device)
    tensors = torch.load(os.path.join(bundle_dir, "params.pt"),
                         map_location="cpu", weights_only=True)
    params: Params = {}
    for path in meta.get("quantized_paths", []):
        params[path] = QTensor(tensors.pop(f"{path}/q"),
                               tensors.pop(f"{path}/scale"), torch.float32)
    params.update(tensors)
    with torch.device(device):
        model = CausalLM(cfg)
    model.load_params(params).eval()
    return model, params, meta
