"""Checkpoint and resume: the port of ``horovod_tpu/utils/checkpoint.py``
on ``torch.save`` / ``torch.load``.

A checkpoint holds a *tree*: nested dicts, lists and tuples of tensors and
numbers, such as :func:`horovod_tpu_torch.parallel.train.state_tree` makes
of a training state.  Who writes follows the JAX package's rule:

* replicated state (no ``mesh`` given) is written by rank 0 alone, as
  ``state.pt``; the other ranks return without writing;
* sharded state (``mesh=`` the mesh the tree is this rank's shard of: a
  ``tp``, ``ep`` or ``pp`` shard, or ZeRO-1 moments) is written by every
  rank, as ``shard_<coordinates>.pt`` named by its mesh coordinates, and
  read back by the rank at the same coordinates.

:func:`save`, :func:`restore`, :func:`exists` and :func:`resume_or_init`
are the plain layer.  The verified layer guards against a checkpoint that
loads but is not what was written (a torn write, bit rot):

* :func:`save_verified` writes ``<root>/step_<n>`` atomically (a temporary
  directory, then a rename) beside a ``step_<n>.manifest.json`` with each
  file's sha256 and size, the step and the elastic membership epoch
  (``HVD_ELASTIC_EPOCH``), and prunes to the newest ``HVD_CKPT_KEEP``
  (default 3).  Sharded state is a collective: gang barriers order every
  rank's write before rank 0 seals the directory, and the seal before any
  rank returns.
* :func:`restore_verified` re-hashes the newest checkpoint's files against
  its manifest and falls back, newest first, past any that fail, raising
  :class:`CheckpointVerifyError` only when none verifies.

A checkpoint that fails verification on restore records a
``CKPT_VERIFY_FAIL`` instant on the engine's timeline
(``utils/timeline.py``).  The ``ckpt.corrupt`` fault site (a ``corrupt``
fault, detail: the sealed directory) flips one byte in the middle of the
largest file right after the manifest is sealed: the torn write that
verification exists to catch.

Left out until telemetry is ported (ROADMAP Queue 1, item 5.5): the
verification counters and the flight recorder's note.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils import _pytree

from horovod_tpu_torch import basics
from horovod_tpu_torch.common import fault_injection as _fi
from horovod_tpu_torch.utils import env as env_util
from horovod_tpu_torch.utils import timeline as timeline_mod

logger = logging.getLogger("horovod_tpu_torch.checkpoint")

MANIFEST_FORMAT = 1
_STEP_DIR = re.compile(r"^step_(\d+)$")


def _file(path: str, mesh) -> str:
    """The file this rank writes and reads under ``path``."""
    if mesh is None:
        return os.path.join(path, "state.pt")
    coords = "-".join(f"{a}{c}" for a, c in mesh.coords.items())
    return os.path.join(path, f"shard_{coords}.pt")


def _writes(mesh) -> bool:
    """Replicated state: rank 0 alone; sharded state: every rank."""
    return mesh is not None or not basics.is_initialized() \
        or basics.rank() == 0


def _write(file: str, tree: Any) -> None:
    """``tree`` with its tensors on the CPU, to ``file`` through a
    temporary name and a rename, fsynced."""
    host = _pytree.tree_map(
        lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
        tree)
    tmp = f"{file}.tmp.{os.getpid()}"
    with open(tmp, "wb") as fh:
        torch.save(host, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, file)


def save(path: str, tree: Any, *, mesh=None, force: bool = True) -> bool:
    """Write ``tree`` under the directory ``path``.  Returns True if this
    process wrote.  Without ``mesh`` the tree is replicated and only rank 0
    writes (the others call :func:`~horovod_tpu_torch.ops.collective.
    barrier` themselves where they must wait for it); with ``mesh`` every
    rank writes its shard."""
    if not _writes(mesh):
        return False
    file = _file(path, mesh)
    if not force and os.path.exists(file):
        raise FileExistsError(file)
    os.makedirs(path, exist_ok=True)
    _write(file, tree)
    return True


def restore(path: str, template: Optional[Any] = None, *, mesh=None) -> Any:
    """Read this rank's tree from ``path`` (CPU tensors).  With
    ``template``, a tree of the same structure, each tensor takes its
    template's device and dtype; a different structure raises
    ``ValueError``."""
    tree = torch.load(_file(path, mesh), map_location="cpu",
                      weights_only=True)
    if template is None:
        return tree
    leaves, spec = _pytree.tree_flatten(tree)
    want, want_spec = _pytree.tree_flatten(template)
    if spec != want_spec:
        raise ValueError(f"checkpoint {path!r} does not have the template's "
                         "structure")
    return _pytree.tree_unflatten(
        [a.to(t.device, t.dtype) if isinstance(t, torch.Tensor) else a
         for a, t in zip(leaves, want)], spec)


def exists(path: str) -> bool:
    return os.path.isdir(path) and bool(os.listdir(path))


def resume_or_init(path: str, init_fn: Callable[[], Any], *,
                   broadcast: bool = True, mesh=None) -> Any:
    """Restore ``path`` if present (into ``init_fn()``'s structure,
    devices and dtypes), else ``init_fn()``; a fresh replicated state is
    broadcast from rank 0 where ``broadcast``, so that every rank starts
    from the same one."""
    state = init_fn()
    if exists(path):
        return restore(path, state, mesh=mesh)
    if broadcast and mesh is None and basics.is_initialized() \
            and basics.size() > 1:
        from horovod_tpu_torch.ops import collective as C

        state = _pytree.tree_map(
            lambda t: C.broadcast(t, 0) if isinstance(t, torch.Tensor)
            else t, state)
    return state


# -- verified checkpoints -------------------------------------------------


class CheckpointVerifyError(RuntimeError):
    """Checkpoints exist under the root but none passed verification."""

    def __init__(self, root: str, failures):
        self.root = root
        self.failures = list(failures)
        detail = "; ".join(f"{os.path.basename(p)}: {r}"
                           for p, r in self.failures)
        super().__init__(
            f"no verifiable checkpoint under {root!r}: every candidate "
            f"failed its manifest check ({detail}); restore from a backup "
            f"or re-initialize")


def manifest_path(ckpt_dir: str) -> str:
    return ckpt_dir.rstrip("/") + ".manifest.json"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _walk_files(root: str) -> List[str]:
    out = []
    for dirpath, _, names in os.walk(root):
        for n in names:
            out.append(os.path.relpath(os.path.join(dirpath, n), root))
    return sorted(out)


def _write_manifest(ckpt_dir: str, step: int, epoch: int) -> None:
    files = {}
    for rel in _walk_files(ckpt_dir):
        full = os.path.join(ckpt_dir, rel)
        files[rel] = {"sha256": _sha256_file(full),
                      "bytes": os.path.getsize(full)}
    manifest = {"format": MANIFEST_FORMAT, "step": step, "epoch": epoch,
                "files": files}
    target = manifest_path(ckpt_dir)
    tmp = f"{target}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, target)


def verify_checkpoint(ckpt_dir: str) -> Tuple[bool, str]:
    """``(ok, reason)``: re-hash every file the manifest lists.  Extra
    files are tolerated; missing or mismatching ones are not."""
    mpath = manifest_path(ckpt_dir)
    if not os.path.isfile(mpath):
        return False, "no manifest sidecar"
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
        files = manifest["files"]
    except (ValueError, KeyError, TypeError) as e:
        return False, f"unreadable manifest ({e})"
    for rel, meta in sorted(files.items()):
        full = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(full):
            return False, f"missing file {rel!r}"
        if _sha256_file(full) != meta.get("sha256"):
            return False, f"sha256 mismatch on {rel!r}"
    return True, ""


def list_steps(root: str) -> List[Tuple[int, str]]:
    """``(step, dir)`` pairs under ``root``, newest step first."""
    out = []
    if os.path.isdir(root):
        for name in os.listdir(root):
            m = _STEP_DIR.match(name)
            if m and os.path.isdir(os.path.join(root, name)):
                out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out, reverse=True)


def _corrupt_one_file(ckpt_dir: str) -> None:
    """The ``ckpt.corrupt`` fault: flip one byte in the middle of the
    largest file, after the manifest was sealed."""
    rels = _walk_files(ckpt_dir)
    if not rels:
        return
    target = max(rels, key=lambda r: os.path.getsize(
        os.path.join(ckpt_dir, r)))
    full = os.path.join(ckpt_dir, target)
    size = os.path.getsize(full)
    if size == 0:
        return
    with open(full, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))


def _prune(root: str, keep: int) -> None:
    for _, d in list_steps(root)[keep:]:
        shutil.rmtree(d, ignore_errors=True)
        try:
            os.remove(manifest_path(d))
        except OSError:
            pass


def _gang_barrier() -> None:
    if basics.is_initialized() and basics.size() > 1:
        from horovod_tpu_torch.ops import collective as C

        C.barrier()


def save_verified(root: str, tree: Any, *, step: int,
                  keep: Optional[int] = None, force: bool = True,
                  mesh=None) -> Optional[str]:
    """Atomically write ``<root>/step_<step>`` and its manifest; prune to
    the newest ``keep`` (``HVD_CKPT_KEEP``, default 3).  Returns the final
    directory, or None on a rank that does not write (replicated state,
    rank other than 0).

    With ``mesh`` (sharded state) every rank must call it: the temporary
    directory's name is the same on every rank, and gang barriers put
    every rank's shard on disk before rank 0 seals the checkpoint (rename,
    manifest, prune), and the seal before any rank returns."""
    keep = keep if keep is not None else env_util.get_int(
        env_util.CKPT_KEEP, 3)
    if keep < 1:
        raise ValueError("checkpoint retention (keep) must be >= 1")
    final = os.path.join(root, f"step_{step}")
    if not _writes(mesh):
        return None
    collective = mesh is not None and basics.is_initialized() \
        and basics.size() > 1
    if not force and os.path.isdir(final):
        raise FileExistsError(final)
    os.makedirs(root, exist_ok=True)
    if collective:
        tmp = os.path.join(root, f".tmp.step_{step}")
        if basics.rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
        _gang_barrier()  # leftover tmp cleared before anyone writes
    else:
        tmp = os.path.join(root, f".tmp.step_{step}.{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)
    _write(_file(tmp, mesh), tree)
    if collective:
        _gang_barrier()  # every rank's shard durable before the seal
    if not collective or basics.rank() == 0:
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _write_manifest(final, step,
                        env_util.get_int(env_util.ELASTIC_EPOCH, 0))
        if _fi.should_corrupt("ckpt.corrupt", final):
            _corrupt_one_file(final)
        _prune(root, keep)
    if collective:
        _gang_barrier()  # the sealed dir is visible on every rank's return
    return final


def restore_verified(root: str, template: Optional[Any] = None, *,
                     mesh=None) -> Tuple[Any, int]:
    """Newest-first verified restore: ``(tree, step)`` from the newest
    checkpoint whose manifest checks out, falling back past any that do not
    (each fallback logs a warning and records ``CKPT_VERIFY_FAIL`` on the
    timeline).  Raises ``FileNotFoundError`` with no
    candidates at all, :class:`CheckpointVerifyError` when none verify."""
    candidates = list_steps(root)
    if not candidates:
        raise FileNotFoundError(f"no step_<n> checkpoints under {root!r}")
    failures = []
    for step, d in candidates:
        ok, reason = verify_checkpoint(d)
        if not ok:
            logger.warning("checkpoint %s failed verification (%s); "
                           "falling back to the next newest", d, reason)
            timeline_mod.engine_event(
                timeline_mod.CKPT_VERIFY_FAIL, path=d, reason=reason)
            failures.append((d, reason))
            continue
        return restore(d, template, mesh=mesh), step
    raise CheckpointVerifyError(root, failures)
