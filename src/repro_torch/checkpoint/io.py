"""Checkpoints of tensor trees: ``arrays.npz`` + ``manifest.json``.

Port of ``repro.checkpoint.io`` in the reference's format, so that a
checkpoint written by either package loads in the other:

  * a checkpoint is a directory holding ``arrays.npz`` (one array per
    leaf) and ``manifest.json`` (``step``, ``treedef``, ``keys``,
    ``extra``);
  * a leaf's npz key is its path joined by ``/``.  The port's flat
    parameter dicts are keyed by dotted paths (``"rec0.w"``,
    ``"periods.slot2.attn.wq"``), and each dot is a level of the
    reference's nested pytree, so ``{"params": {"rec0.w": t}}`` gives
    ``params/rec0/w`` — the key the reference writes for the same state;
  * bfloat16 leaves are stored as the reference stores them, 2-byte
    void records (``|V2``) holding the bf16 bits, and read back by
    viewing those bits as ``torch.bfloat16`` (the reference's own loader
    cannot cast ``|V2`` back; ROADMAP §3);
  * ``treedef`` holds the fixed string ``TREEDEF``; no loader of either
    package reads it.

Loading rebuilds the structure of ``like``: each leaf takes the dtype
and the device of its ``like`` tensor.

``save_train_state`` / ``load_train_state`` persist the full training
state ``(params, opt_state, step)``, so that a killed run resumed from a
checkpoint continues as the uninterrupted run would (momentum, Adam's
moments, λ, the warm-start Δθ, the preconditioner's statistics and the
step counter all survive).  ``load_train_state`` also reads the
reference's legacy params-only checkpoints; the optimiser state then
starts fresh.

Under a mesh (``shardings=``, a tree of ``launch.sharding.NamedSharding``
matching the saved tree, or the parameters' and the optimiser state's
for the train state): every rank gathers each leaf split across ranks
(``launch.fsdp.gather_whole``, one leaf at a time), rank 0 alone writes
the whole leaves, the same bytes as a one-process save, and every rank
waits at a barrier until the checkpoint is on disk.  Every rank reads,
and ``place`` cuts each loaded leaf to the rank's share on the host
before it moves to the device.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.fsdp import gather_whole

logger = logging.getLogger(__name__)

SEP = "/"
TRAIN_STATE_FORMAT = "train-state-v1"
BF16_RECORD = np.dtype("V2")       # how numpy stores a bfloat16 leaf
TREEDEF = "repro_torch: keys"      # the manifest's treedef, never read


def _children(tree):
    """(key, child) pairs of a container, None for a leaf.  Dict keys
    split at dots into levels; list and tuple entries are keyed by
    index."""
    if isinstance(tree, dict):
        return [(str(k).replace(".", SEP), v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _join(prefix: str, key: str) -> str:
    return f"{prefix}{SEP}{key}" if prefix else key


def _flatten(tree, prefix: str = "") -> dict:
    """{npz key: leaf} in tree order; None and empty containers have no
    leaves."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for key, value in kids:
        flat.update(_flatten(value, _join(prefix, key)))
    return flat


def _rebuild(like, leaves: dict, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``leaves[key]``."""
    if like is None:
        return None
    kids = _children(like)
    if kids is None:
        return leaves[prefix]
    out = [_rebuild(v, leaves, _join(prefix, key)) for key, v in kids]
    return dict(zip(like, out)) if isinstance(like, dict) \
        else type(like)(out)


def _to_numpy(leaf) -> np.ndarray:
    """One leaf as a host array; a tensor on the card is copied once."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def _to_tensor(arr: np.ndarray, like, sharding=None):
    """An array read from the npz -> a tensor with ``like``'s dtype and
    device (a ``|V2`` record is a bf16 leaf's bits), cut to this rank's
    share by ``sharding`` first when one is given."""
    if arr.dtype == BF16_RECORD:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if sharding is not None:
        t = sharding.place(t)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


def _sharding_leaves(shardings) -> list:
    """The shardings of a sharding tree; ``TypeError`` for a leaf that
    is not one."""
    leaves = [s for s in _flatten(shardings).values() if s is not None]
    for s in leaves:
        if not (hasattr(s, "place") and hasattr(s, "mesh")):
            raise TypeError(f"shardings: a leaf is a {type(s).__name__}, "
                            f"not a launch.sharding.NamedSharding")
    return leaves


def _check_share(key: str, t, like) -> None:
    want = tuple(getattr(like, "shape", ()))
    if isinstance(t, torch.Tensor) and tuple(t.shape) != want:
        raise ValueError(f"{key}: this rank's share is {tuple(t.shape)}, "
                         f"the state holds {want}")


def _write(ckpt_dir: str, flat: dict, step: int, extra) -> None:
    """Write {npz key: host array} atomically: a temp dir beside
    ``ckpt_dir``, then renamed over it."""
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(ckpt_dir)),
                           prefix=".ckpt-")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": int(step), "treedef": TREEDEF,
                    "keys": sorted(flat), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.rename(tmp, ckpt_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def save_checkpoint(ckpt_dir: str, tree, *, step: int = 0,
                    extra: Optional[dict] = None, shardings=None) -> None:
    """Atomic save: write a temp dir beside ``ckpt_dir``, then replace
    ``ckpt_dir`` by it.  A save that fails while writing leaves the
    previous checkpoint (if any) and no temp dir.  Under ``shardings``
    every rank gathers the split leaves, rank 0 writes, and every rank
    returns once it has."""
    t0 = time.perf_counter()
    rank0 = True
    flat_s = {}
    if shardings is not None:
        _sharding_leaves(shardings)
        flat_s = _flatten(shardings)
        if any(s.pieces() > 1 for s in flat_s.values() if s is not None) \
                and not dist.is_initialized():
            raise RuntimeError(
                "save_checkpoint: a leaf split across ranks is gathered "
                "over the mesh's process group, and none is running")
        rank0 = dist.get_rank() == 0
    flat = {}
    for k, v in _flatten(tree).items():
        s = flat_s.get(k)
        if s is not None and s.pieces() > 1:
            v = gather_whole(v, s)
        if rank0:
            flat[k] = _to_numpy(v)
    t_host = time.perf_counter() - t0
    if rank0:
        _write(ckpt_dir, flat, step, extra)
        logger.info("saved %d leaves (%.1f MB) at step %d to %s: host copy "
                    "%.3f s, total %.3f s", len(flat),
                    sum(a.nbytes for a in flat.values()) / 1e6, int(step),
                    ckpt_dir, t_host, time.perf_counter() - t0)
    if shardings is not None:
        dist.barrier()


def read_manifest(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        return json.load(f)


def load_checkpoint(ckpt_dir: str, like, *, shardings=None):
    """Restore into the structure of ``like``; returns ``(tree, step)``.
    Raises ``ValueError`` when a leaf of ``like`` has no array.
    ``shardings``: a tree of ``NamedSharding`` matching ``like`` (None
    leaves load as they are); each leaf is placed by its sharding and
    must then have its ``like`` leaf's shape."""
    t0 = time.perf_counter()
    manifest = read_manifest(ckpt_dir)
    flat_like = _flatten(like)
    flat_s = {}
    if shardings is not None:
        _sharding_leaves(shardings)
        flat_s = _flatten(shardings)
    with np.load(os.path.join(ckpt_dir, "arrays.npz")) as data:
        missing = set(flat_like) - set(data.files)
        if missing:
            raise ValueError(
                f"checkpoint missing keys: {sorted(missing)[:5]} ...")
        leaves = {}
        for k, leaf in flat_like.items():
            leaves[k] = _to_tensor(data[k], leaf, flat_s.get(k))
            if k in flat_s:
                _check_share(k, leaves[k], leaf)
    tree = _rebuild(like, leaves)
    logger.info("loaded %d leaves at step %d from %s in %.3f s",
                len(leaves), manifest["step"], ckpt_dir,
                time.perf_counter() - t0)
    return tree, manifest["step"]


def _state_shardings(shardings, state_shardings):
    if shardings is None and state_shardings is None:
        return None
    return {"params": shardings, "opt_state": state_shardings}


def save_train_state(ckpt_dir: str, params, opt_state, *, step: int = 0,
                     extra: Optional[dict] = None, shardings=None,
                     state_shardings=None) -> None:
    """Atomic save of the full training state (params + optimiser state).
    ``shardings``: the parameters' (a mesh run: rank 0 writes);
    ``state_shardings``: the optimiser state's (``Optimizer.
    state_shardings``), where it holds split leaves."""
    meta = dict(extra or {}, format=TRAIN_STATE_FORMAT)
    save_checkpoint(ckpt_dir, {"params": params, "opt_state": opt_state},
                    step=step, extra=meta,
                    shardings=_state_shardings(shardings, state_shardings))


def load_train_state(ckpt_dir: str, params_like, opt_state_like, *,
                     shardings=None, state_shardings=None):
    """Restore ``(params, opt_state, step)``.  A legacy params-only
    checkpoint restores the params and returns ``opt_state_like``
    untouched (fresh optimiser state).  ``shardings``: the parameters'
    (``NamedSharding`` by key), ``state_shardings`` the optimiser
    state's; each leaf is placed by its own, and a leaf without one
    loads whole."""
    if read_manifest(ckpt_dir).get("extra", {}).get("format") \
            != TRAIN_STATE_FORMAT:
        params, step = load_checkpoint(ckpt_dir, params_like,
                                       shardings=shardings)
        return params, opt_state_like, step
    try:
        tree, step = load_checkpoint(
            ckpt_dir, {"params": params_like, "opt_state": opt_state_like},
            shardings=_state_shardings(shardings, state_shardings))
    except ValueError as e:
        raise ValueError(
            f"checkpoint at {ckpt_dir!r} does not match the current "
            "training state structure — was it saved with different "
            "optimiser flags (--optimizer / --warm-start / "
            f"--preconditioner)? ({e})") from e
    return tree["params"], tree["opt_state"], step
