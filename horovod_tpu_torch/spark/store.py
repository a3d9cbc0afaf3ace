"""Training artifact stores for the estimator API: the port of
``horovod_tpu/spark/store.py``, line for line but for one comment (it
imports nothing of either package).

Role parity: ``horovod/spark/common/store.py:149-426`` (FilesystemStore →
LocalStore/HDFSStore — a filesystem abstraction over train-data, runs,
checkpoints and logs, with Petastorm materialization).  Redesigned:

* shards are plain parquet files written with pyarrow through the
  store's own ``open()`` — no Petastorm dependency;
* the remote backend is **fsspec** (:class:`FsspecStore`) rather than a
  bespoke HDFS client: the analog of HDFSStore is an object store
  (``gs://`` / ``s3://``), and fsspec serves those, ``hdfs://``, and
  ``memory://`` (which the tests use as a real non-local backend)
  through one interface;
* checkpoint/resume helpers (:meth:`Store.save_checkpoint`,
  :meth:`Store.latest_checkpoint`) give the estimators the reference's
  per-run checkpoint directory contract (``get_checkpoint_path`` +
  torch/remote.py epoch checkpointing) in byte-oriented form that works
  identically on local disk and object stores.

``Store.create`` picks the backend by URL scheme, like the reference's
``Store.create`` → ``FilesystemStore.matches`` dispatch.  Nothing is left
out.
"""

from __future__ import annotations

import os
import posixpath
import re
import shutil
from typing import List, Optional, Tuple


class Store:
    """Filesystem layout for one estimator workspace:

    ``<prefix>/intermediate_train_data/<run_id>/part-NNNNN.parquet``
    ``<prefix>/runs/<run_id>/checkpoint.*``
    ``<prefix>/runs/<run_id>/logs/``
    """

    def __init__(self, prefix_path: str):
        self.prefix_path = prefix_path

    @staticmethod
    def create(prefix_path: str) -> "Store":
        """Backend by URL scheme (parity: store.py:142 Store.create):
        plain paths → :class:`LocalStore`; ``scheme://`` URLs →
        :class:`FsspecStore` (gs/s3/hdfs/memory/...)."""
        if re.match(r"^[a-zA-Z0-9]+://", prefix_path) and \
                not prefix_path.startswith("file://"):
            return FsspecStore(prefix_path)
        if prefix_path.startswith("file://"):
            prefix_path = prefix_path[len("file://"):]
        return LocalStore(prefix_path)

    # -- layout ----------------------------------------------------------

    def join(self, *parts: str) -> str:
        return os.path.join(*parts)

    def train_data_path(self, run_id: str) -> str:
        return self.join(self.prefix_path, "intermediate_train_data",
                          run_id)

    def val_data_path(self, run_id: str) -> str:
        """Validation shards (parity: store.py get_val_data_path)."""
        return self.join(self.prefix_path, "intermediate_val_data",
                          run_id)

    def run_path(self, run_id: str) -> str:
        return self.join(self.prefix_path, "runs", run_id)

    def checkpoint_path(self, run_id: str) -> str:
        return self.join(self.run_path(run_id), "checkpoint")

    def logs_path(self, run_id: str) -> str:
        return self.join(self.run_path(run_id), "logs")

    # -- fs ops (backend-specific) --------------------------------------

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def open(self, path: str, mode: str = "rb"):
        """Open a file in the store (binary modes only — parquet and
        checkpoint payloads are bytes)."""
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        """Full paths of directory entries ([] if absent)."""
        raise NotImplementedError

    # -- shared helpers built on the ops --------------------------------

    def shard_paths(self, run_id: str, val: bool = False) -> List[str]:
        d = (self.val_data_path(run_id) if val
             else self.train_data_path(run_id))
        return sorted(p for p in self.listdir(d)
                      if p.endswith(".parquet"))

    def read_bytes(self, path: str) -> bytes:
        with self.open(path, "rb") as f:
            return f.read()

    def write_bytes(self, path: str, data: bytes) -> None:
        parent = posixpath.dirname(path) if "://" in path \
            else os.path.dirname(path)
        self.makedirs(parent)
        with self.open(path, "wb") as f:
            f.write(data)

    # -- checkpoint/resume (parity: torch/remote.py epoch checkpoints
    #    under get_checkpoint_path; byte-oriented so object stores work)

    def save_checkpoint(self, run_id: str, epoch: int,
                        payload: bytes, keep: int = 2) -> str:
        """Write this epoch's checkpoint and prune all but the newest
        ``keep`` (only the newest is ever read back; without pruning a
        long fit accumulates one full model+optimizer snapshot per
        epoch in the store)."""
        path = self.join(self.run_path(run_id),
                          f"checkpoint-epoch{epoch:05d}.bin")
        self.write_bytes(path, payload)
        pat = re.compile(r"checkpoint-epoch(\d+)\.bin$")
        found = sorted((int(m.group(1)), p)
                       for p in self.listdir(self.run_path(run_id))
                       for m in [pat.search(p)] if m)
        for _, old in found[:-keep] if keep > 0 else []:
            self.delete(old)
        return path

    def latest_checkpoint(
            self, run_id: str) -> Optional[Tuple[int, bytes]]:
        """(epoch, payload) of the newest epoch checkpoint, or None."""
        pat = re.compile(r"checkpoint-epoch(\d+)\.bin$")
        best = None
        for p in self.listdir(self.run_path(run_id)):
            m = pat.search(p)
            if m and (best is None or int(m.group(1)) > best[0]):
                best = (int(m.group(1)), p)
        if best is None:
            return None
        return best[0], self.read_bytes(best[1])


class LocalStore(Store):
    """Local-filesystem store (parity: spark/common/store.py:250
    LocalStore)."""

    def __init__(self, prefix_path: str):
        super().__init__(os.path.abspath(prefix_path))

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def open(self, path: str, mode: str = "rb"):
        if "w" in mode:
            os.makedirs(os.path.dirname(path), exist_ok=True)
        return open(path, mode)

    def listdir(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            return []
        return [os.path.join(path, f) for f in os.listdir(path)]


class FsspecStore(Store):
    """Remote store over any fsspec filesystem (parity role:
    spark/common/store.py:294 HDFSStore — the reference's non-local
    backend; on a cluster the natural remote is an object store, so the
    backend is chosen by the URL: ``gs://bucket/prefix``,
    ``s3://bucket/prefix``, ``hdfs://nn/prefix``, ``memory://prefix``).

    All paths this store hands out keep the scheme, so a path is usable
    by whichever worker process receives it regardless of host.
    """

    def __init__(self, prefix_path: str):
        try:
            import fsspec
        except ImportError as e:  # pragma: no cover - fsspec is baked in
            raise ImportError(
                "FsspecStore needs the 'fsspec' package for remote "
                "stores; install it or use a local path") from e
        self._fs, _stripped = fsspec.core.url_to_fs(prefix_path)
        self._scheme = prefix_path.split("://", 1)[0]
        super().__init__(prefix_path.rstrip("/"))

    # fsspec filesystems return scheme-less paths; keep our surface
    # uniform by re-attaching the scheme.
    def _with_scheme(self, path: str) -> str:
        if "://" in path:
            return path
        # fs-native paths keep their leading slash (file/memory) or
        # bucket prefix (s3/gs) — prepend the scheme verbatim;
        # "file://tmp/x" would silently become a cwd-relative path.
        return f"{self._scheme}://{path}"

    def join(self, *parts: str) -> str:
        return posixpath.join(*parts)

    def exists(self, path: str) -> bool:
        return self._fs.exists(path)

    def makedirs(self, path: str) -> None:
        # Object stores have no real directories; mkdirs is best-effort
        # and some fsspec backends raise on existing paths.
        try:
            self._fs.makedirs(path, exist_ok=True)
        except (FileExistsError, NotImplementedError):
            pass

    def delete(self, path: str) -> None:
        if self._fs.exists(path):
            self._fs.rm(path, recursive=True)

    def open(self, path: str, mode: str = "rb"):
        return self._fs.open(path, mode)

    def listdir(self, path: str) -> List[str]:
        try:
            if not self._fs.exists(path):
                return []
            return [self._with_scheme(p)
                    for p in self._fs.ls(path, detail=False)]
        except FileNotFoundError:
            return []
