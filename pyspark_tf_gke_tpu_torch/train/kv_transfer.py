"""KV page-blob serialization for the prefill/decode handoff: the
port's byte-compatible copy of ``pyspark_tf_gke_tpu/train/kv_transfer.py``
(a blob packed by either package unpacks in the other).

``ContinuousEngine.export_prefix_pages`` returns host arrays; this
module flattens them into ONE self-describing ``.npz`` byte blob and
inverts it on the import side. Native numpy dtypes ride through
verbatim (int8 pages stay int8); EXTENSION dtypes (a JAX bfloat16 pool)
have no npz encoding, so those widen to float32 on the wire, losslessly,
and the import-side page install casts back to the pool dtype. The
port's own export already hands bf16 pools over as float32 (numpy has
no bfloat16), which gives the same blob.

Uncompressed on purpose: KV rows are high-entropy activations, and a
deflate pass costs milliseconds per page for single-digit-percent
savings.
"""

from __future__ import annotations

import io
from typing import Dict, List

import numpy as np

__all__ = ["pack_kv_export", "unpack_kv_blob"]


def pack_kv_export(export: dict) -> bytes:
    """Serialize an ``export_prefix_pages`` result
    (``{token_ids, page_size, layers}``) into one ``.npz`` blob.
    Layer leaves are stored as ``l<idx>_<key>`` members — the layer
    index prefix keeps per-layer dicts reconstructible without any
    side-channel schema."""
    arrays: Dict[str, np.ndarray] = {
        "token_ids": np.asarray(export["token_ids"], np.int32),
        "page_size": np.asarray([int(export["page_size"])], np.int32),
    }
    for i, rec in enumerate(export["layers"]):
        for key, leaf in rec.items():
            leaf = np.asarray(leaf)
            if leaf.dtype.kind not in "iuf":
                # extension dtype (bfloat16 pool): widen to float32 —
                # npz can't encode it, and the installer casts back
                leaf = leaf.astype(np.float32)
            arrays[f"l{i}_{key}"] = leaf
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def unpack_kv_blob(data: bytes) -> dict:
    """Inverse of :func:`pack_kv_export`: bytes back to
    ``{token_ids, page_size, layers}`` with per-layer host-array
    dicts in layer order. Raises ``ValueError`` on a malformed blob
    (the import handler answers 400 and the router falls back to
    RECOMPUTE)."""
    try:
        with np.load(io.BytesIO(data)) as z:
            token_ids = [int(t) for t in z["token_ids"]]
            page_size = int(z["page_size"][0])
            by_layer: Dict[int, Dict[str, np.ndarray]] = {}
            for name in z.files:
                if not name.startswith("l") or "_" not in name:
                    continue
                idx_s, key = name[1:].split("_", 1)
                arr = z[name]
                if arr.dtype.kind not in "iuf":
                    raise ValueError(
                        f"KV transfer blob member {name} has "
                        f"unsupported dtype {arr.dtype}")
                by_layer.setdefault(int(idx_s), {})[key] = arr
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(f"malformed KV transfer blob: {exc}") from exc
    if not by_layer:
        raise ValueError("KV transfer blob holds no layer pages")
    layers: List[Dict[str, np.ndarray]] = [
        by_layer[i] for i in sorted(by_layer)]
    if len(layers) != len(by_layer) or sorted(by_layer)[0] != 0:
        raise ValueError("KV transfer blob has non-contiguous layers")
    return {"token_ids": token_ids, "page_size": page_size,
            "layers": layers}
