"""Carry state from the reference package into the port, as numpy.

The port imports nothing of the JAX package; what crosses over is plain
arrays.  A caller holding JAX-side objects turns them into numpy first
(``np.asarray`` on each field) and hands them here.

  * ``lattice_from_numpy`` — an unbatched lattice dict (the builders'
    format) or the fields of a batched JAX ``Lattice`` -> the port's
    ``Lattice`` on a device, with the reference's dtypes.
  * ``stream_checkpoint_from_numpy`` — a JAX ``StreamSession.
    checkpoint``, i.e. ``(done, alpha, c_alpha)``, loaded into a port
    ``StreamSession`` so its next ``rescore`` resumes from it.

  * ``acoustic_params_from_numpy`` — a JAX acoustic-model pytree
    (``{"rec0": {"w": ..., "b": ...}, ...}``) -> the port's flat
    ``{"rec0.w": ..., "rec0.b": ...}`` dict, same layouts.
  * ``lm_params_from_numpy`` — a JAX language-model pytree
    (``{"embed": {...}, "periods": {"slot0": {...}}, ...}``, leaves
    stacked over periods) -> the port's flat dict keyed by tree path
    (``"periods.slot2.attn.wq"``), same layouts and stacking.
"""
from __future__ import annotations

import numpy as np

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.losses.lattice import Lattice, as_tensor, batch_lattices
from repro_torch.models.transformer import flatten
from repro_torch.serving.streaming import StreamSession


def lattice_from_numpy(lat, device=DEFAULT_DEVICE) -> Lattice:
    """``lat``: an unbatched lattice dict ({field: array}, ``start_t`` of
    shape (A,)), or a batched lattice given as a mapping or a NamedTuple
    of arrays (a JAX ``Lattice`` whose fields went through ``np.asarray``
    or still are arrays that convert).  Returns the port's ``Lattice``."""
    fields = lat._asdict() if hasattr(lat, "_asdict") else dict(lat)
    missing = [k for k in Lattice._fields[:-1] if k not in fields]
    if missing:
        raise ValueError(f"lattice_from_numpy: missing fields {missing}")
    if np.asarray(fields["start_t"]).ndim == 1:
        return batch_lattices([{k: np.asarray(v) for k, v in fields.items()
                                if k in Lattice._fields}], device=device)
    dev = resolve_device(device)
    return Lattice(**{k: (None if fields.get(k) is None
                          else as_tensor(np.asarray(fields[k]), dev))
                      for k in Lattice._fields})


def stream_checkpoint_from_numpy(session: StreamSession,
                                 checkpoint) -> StreamSession:
    """Load a reference ``StreamSession.checkpoint`` — ``(done, alpha,
    c_alpha)`` over the session bucket's arcs — into ``session`` and
    return it.  The next ``session.rescore`` resumes from that frontier."""
    if checkpoint is None:
        raise ValueError("stream_checkpoint_from_numpy: the session had "
                         "no checkpoint yet (rescore was never called)")
    done, alpha, c_alpha = (np.asarray(x) for x in checkpoint)
    session.restore(done, alpha, c_alpha)
    return session


def acoustic_params_from_numpy(tree, device=DEFAULT_DEVICE) -> dict:
    """Nested {layer: {"w": array, "b": array}} (a reference acoustic
    parameter pytree, leaves as arrays or anything ``np.asarray`` takes)
    -> flat {"layer.w": f32 tensor, ...} on ``device``.  The reference's
    weight layout (``x @ w + b``, w of shape (d_in, d_out)) and LSTM gate
    order are the port's, so no leaf is transposed or reordered."""
    dev = resolve_device(device)
    out = {}
    for layer, leaves in tree.items():
        for name, value in leaves.items():
            out[f"{layer}.{name}"] = torch.from_numpy(
                np.array(value, dtype=np.float32)).to(dev)
    return out


def lm_params_from_numpy(tree, device=DEFAULT_DEVICE) -> dict:
    """Nested dict of arrays (a reference LM parameter pytree, leaves as
    numpy or anything ``np.asarray`` takes; ``periods.slotN.*`` stacked
    over periods) -> flat {"path.to.leaf": tensor} on ``device``, in
    the leaves' dtypes (bfloat16 leaves stay bfloat16).  Nothing is
    transposed or reordered: the port's models use the reference's
    layouts and stacking."""
    dev = resolve_device(device)
    out = {}
    for path, value in flatten(tree).items():
        arr = np.asarray(value)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        out[path] = t.to(dev)
    return out
