"""Filesystem access for the training data plane (the port's copy of
``pyspark_tf_gke_tpu/utils/fs.py``): local paths plus fsspec URLs
(``gs://`` in production, ``memory://`` in the tests).

* ``fs_open`` / ``fs_glob``: streaming reads and sorted shard-pattern
  expansion (the scheme is kept on remote matches);
* ``fs_write_text``: a small text artifact written whole — one object
  write on a store, a same-directory temp file and an atomic rename on
  a local disk;
* ``fs_makedirs``: ``mkdir -p`` locally, nothing on an object store
  (objects exist under a prefix, not in directories);
* ``fs_copy_tree``: pull a remote directory tree (a serving bundle);
* ``spool_local``: stage a remote object into a per-user spool file for
  readers that want a real file.

fsspec is imported only when a remote path arrives. HTTP(S) is not
handled here, as in the JAX package.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
import shutil
import tempfile
from typing import IO, List, Optional

_HTTP = ("http://", "https://")


def is_remote(path: str) -> bool:
    """True for fsspec-routed URLs (gs://, s3://, memory://, ...); False
    for local paths and http(s)."""
    return "://" in path and not path.startswith(_HTTP)


def fs_open(path: str, mode: str = "rb") -> IO:
    """Open a local file or an fsspec URL."""
    if is_remote(path):
        import fsspec

        return fsspec.open(path, mode).open()
    return open(path, mode)


def fs_glob(pattern: str) -> List[str]:
    """Sorted glob for local patterns and fsspec URLs (scheme kept)."""
    if is_remote(pattern):
        import fsspec

        fs, _, _ = fsspec.get_fs_token_paths(pattern)
        return sorted(fs.unstrip_protocol(p) for p in fs.glob(pattern))
    return sorted(_glob.glob(pattern))


def fs_makedirs(path: str) -> None:
    """``mkdir -p`` for local paths; a no-op on object stores."""
    if not is_remote(path):
        os.makedirs(path, exist_ok=True)


def fs_write_text(path: str, text: str) -> str:
    """Write a small text artifact (history.json, run notes) whole:
    concurrent readers never see a torn file."""
    if is_remote(path):
        import fsspec

        with fsspec.open(path, "w") as fh:
            fh.write(text)
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
    os.replace(tmp, path)
    return path


def fs_copy_tree(url: str, local_dir: str) -> str:
    """Copy the remote directory tree at ``url`` into ``local_dir`` (its
    contents, not a nested basename directory)."""
    if not is_remote(url):
        raise ValueError(f"fs_copy_tree expects a remote URL, got {url!r}")
    import fsspec

    fs, _, (root,) = fsspec.get_fs_token_paths(url.rstrip("/"))
    os.makedirs(local_dir, exist_ok=True)
    fs.get(root.rstrip("/") + "/", local_dir.rstrip("/") + "/",
           recursive=True)
    return local_dir


def _default_spool_dir() -> str:
    """Per-user spool directory, created 0700: a shared /tmp path would
    let another local user plant spool files."""
    d = os.path.join(tempfile.gettempdir(), f"fs_spool-{os.getuid()}")
    os.makedirs(d, mode=0o700, exist_ok=True)
    if os.stat(d).st_uid != os.getuid():  # made by someone else
        d = tempfile.mkdtemp(prefix="fs_spool-")
    return d


def spool_local(path: str, spool_dir: Optional[str] = None) -> str:
    """A local path for ``path``: remote objects are staged once into a
    spool file whose name keys on the URL and the object's version
    (etag, else mtime, else size), so an overwritten object downloads
    again. Local paths pass through."""
    if not is_remote(path):
        return path
    import fsspec

    fs, _, _ = fsspec.get_fs_token_paths(path)
    try:
        info = fs.info(path)
        version = str(info.get("etag") or info.get("mtime")
                      or info.get("size"))
    except (OSError, ValueError):
        version = ""
    spool_dir = spool_dir or _default_spool_dir()
    os.makedirs(spool_dir, exist_ok=True)
    digest = hashlib.sha1(f"{path}\0{version}".encode()).hexdigest()[:16]
    local = os.path.join(spool_dir, f"{digest}-{os.path.basename(path)}")
    if not os.path.exists(local):
        tmp = f"{local}.tmp.{os.getpid()}"
        with fsspec.open(path, "rb") as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.replace(tmp, local)  # atomic: concurrent spoolers converge
    return local
