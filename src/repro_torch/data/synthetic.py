"""Deterministic synthetic data.

Port of ``repro.data.synthetic``:

  * ``lm_batch`` — Zipfian Markov-chain token streams for LM training
    (next-token labels pre-shifted); the chain has learnable structure,
    so CE decreases;
  * ``asr_batch`` — a sausage lattice per utterance
    (``losses.lattice.make_lattice_batch``) plus acoustic features
    correlated with the reference state sequence (fixed class embeddings
    + noise), so discriminative sequence training has signal to extract.

Pure numpy drawn in the reference's RNG order, so one seed gives the
reference's arrays bitwise; tensors are made on ``device`` at the end.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.losses.lattice import make_lattice_batch


def _zipf_transition(rng: np.random.Generator, vocab: int, branch: int = 16):
    """Sparse Markov chain: each state can emit ``branch`` successors with
    Zipfian weights."""
    succ = rng.integers(0, vocab, size=(vocab, branch))
    w = 1.0 / np.arange(1, branch + 1)
    w = w / w.sum()
    return succ, w


def lm_batch(seed: int, *, batch: int, seq_len: int, vocab: int,
             branch: int = 16, device=DEFAULT_DEVICE) -> dict:
    """{"tokens": (B, T) int32, "labels": (B, T) int32 (the tokens shifted
    by one)} on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    chain_rng = np.random.default_rng(12345)       # chain fixed across batches
    succ, w = _zipf_transition(chain_rng, vocab, branch)
    toks = np.zeros((batch, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab, size=batch)
    choices = rng.choice(branch, size=(batch, seq_len), p=w)
    for t in range(seq_len):
        toks[:, t + 1] = succ[toks[:, t], choices[:, t]]
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(dev),
            "labels": torch.from_numpy(toks[:, 1:].copy()).to(dev)}


def asr_batch(seed: int, *, batch: int, num_frames: int, num_states: int,
              input_dim: int, seg_len: int = 4, n_alt: int = 3,
              noise: float = 1.0, device=DEFAULT_DEVICE) -> dict:
    """{"feats": (B, T, input_dim) f32, "labels": (B, T) int32 frame
    alignment, "lattice": Lattice}, all on ``device``."""
    dev = resolve_device(device)
    lat = make_lattice_batch(seed, batch=batch, num_frames=num_frames,
                             num_states=num_states, seg_len=seg_len,
                             n_alt=n_alt, device=dev)
    emb_rng = np.random.default_rng(777)           # class embeddings fixed
    emb = emb_rng.normal(size=(num_states, input_dim)).astype(np.float32)
    rng = np.random.default_rng(seed + 99991)
    ref = lat.ref_states.cpu().numpy()
    feats = emb[ref] + rng.normal(scale=noise,
                                  size=(batch, num_frames, input_dim)
                                  ).astype(np.float32)
    return {"feats": torch.from_numpy(feats).to(dev),
            "labels": lat.ref_states,
            "lattice": lat}


class EpochPlan:
    """Paper Sec. 4.1: the training set is split into C partitions, each
    used as the gradient batch of one update; the CG batch is sampled
    from the ENTIRE training set (a disjoint seed stream)."""

    def __init__(self, num_updates_per_epoch: int, base_seed: int = 0):
        self.C = num_updates_per_epoch
        self.base_seed = base_seed

    def grad_seed(self, epoch: int, update: int) -> int:
        return self.base_seed + epoch * self.C + update

    def cg_seed(self, epoch: int, update: int) -> int:
        return self.base_seed + 1_000_000 + epoch * self.C + update
