"""Filesystem access for the training data plane (the port's copy of
``pyspark_tf_gke_tpu/utils/fs.py``, local paths only).

``fs_glob``, ``fs_open``, ``fs_write_text`` and ``fs_makedirs`` keep the
JAX package's contracts for local paths: sorted globs, streaming
binary reads, and whole-file text writes through a same-directory temp
file and an atomic rename. Object-store URLs (``gs://`` and any other
``scheme://``) are not ported: :func:`is_remote` recognises them and
every other function raises on them (ROADMAP, P8).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import IO, List

_HTTP = ("http://", "https://")


def is_remote(path: str) -> bool:
    """True for object-store URLs (gs://, s3://, memory://, ...); False
    for local paths and http(s)."""
    return "://" in path and not path.startswith(_HTTP)


def _local(path: str) -> str:
    if is_remote(path):
        raise NotImplementedError(
            f"{path!r}: object-store paths are not ported; the port reads "
            "and writes local paths only (ROADMAP, P8)")
    return path


def fs_open(path: str, mode: str = "rb") -> IO:
    return open(_local(path), mode)


def fs_glob(pattern: str) -> List[str]:
    return sorted(_glob.glob(_local(pattern)))


def fs_makedirs(path: str) -> None:
    os.makedirs(_local(path), exist_ok=True)


def fs_write_text(path: str, text: str) -> str:
    """Write a small text artifact (history.json, run notes) whole:
    concurrent readers never see a torn file."""
    _local(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return path
