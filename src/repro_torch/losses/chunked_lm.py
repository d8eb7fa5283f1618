"""Vocab-chunked LM cross-entropy with matched curvature factors.

Port of ``repro.losses.chunked_lm``.  The full logits tensor (B, T, V)
is never materialised, forward or backward: the loss works on the
pre-head output ``out = (hidden (B,T,d), head (d,V))`` and streams the LM
head and the softmax over chunks of T.

The curvature factors are the exact CE factors pushed through the head:
for per-frame logits a = hW,

    GN:     u=(u_h,u_W) -> ja = u_h W + h u_W ;  ĥa = w (p⊙ja − p(pᵀja))
            cotangents: (ĥa Wᵀ,  hᵀ ĥa)
    Fisher: ĝ = w (p − y) ;  f̂a = S ĝ (ĝᵀ ja) ; the same pull-back,

so the LM head stays inside the Gauss-Newton/Fisher Jacobian.  The
factors take the primal ``(hidden, W)`` and the JVP's ``(u_h, u_W)``
from ``core.curvature``'s product and return the cotangent pair for its
VJP; the loss itself is never inside a ``torch.func`` transform.

Under a mesh each rank holds a share of the batch: ``normalisers`` gives
its token count, ``core.curvature.shard_for`` sums it over the data
group and hands it back as ``batch["norms"]``, and the loss, ``acc`` and
both factors then divide this rank's sums by the global count, so the
group's sum is the reference's mean.  Without ``"norms"`` they divide by
the batch's own B·T.  With sequence-parallel activations the backbone
gathers the whole T before the head (``models.transformer.
forward_hidden``, the reference's ``unshard_seq`` in its ``steps.py``),
so the loss runs on every "model" rank over the whole T of its rows, as
in the reference, and its token counts are summed over the data group
only, never over "model".

Under tensor-parallel compute the head is this rank's V/m columns
(``launch.tensor_parallel.vocab_shard``) and a = h W_local its logits.
Each T chunk then takes the softmax's max over the model group with one
``all_reduce`` and its sums with another, which also carries the label's
logit (and the factors' label term) from the one rank that holds the
label; ``acc``'s argmax is the global one, ties to the lowest index as
``torch.argmax``'s.  The GN factor's pᵀja and the Fisher factor's ĝᵀja
are those sums over the whole vocabulary, ĝ = w (p − y) subtracts y on
the label's owner only, and each rank's cotangents are its share: hᵀĥa
for its columns, and ĥa W_localᵀ, a partial one of the hidden state,
which the backbone's entry to the head (``tensor_parallel.enter``: f,
or with the stream split over T the all-gather's reduce-scatter) sums
over the group.  A head the model group does not split (a vocabulary it
does not divide) runs whole on every rank, as on one device; with the
stream split its entry's backward keeps this rank's T slice of the
cotangent.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import tensor_parallel as tp


def _chunks(T: int, t_chunk: int) -> int:
    """The largest chunk length <= t_chunk that divides T."""
    t_chunk = min(t_chunk, T)
    while T % t_chunk:
        t_chunk -= 1
    return t_chunk


def _grad_logits(a, y, scale):
    """(softmax(a) - onehot(y)) * scale without a one-hot tensor."""
    g = torch.softmax(a, -1)
    g.scatter_add_(-1, y[..., None].long(),
                   torch.full_like(g[..., :1], -1.0))
    return g * scale


def _owner(y, shard):
    """(the label's column on this rank, clamped into range; whether this
    rank holds it) of global label ids ``y``."""
    local = y.long() - shard.start
    inside = (local >= 0) & (local < shard.size)
    return local.clamp(0, shard.size - 1), inside


def _shard_softmax(a, y, shard, extra=()):
    """The softmax of the whole vocabulary's logits of which ``a`` (...,
    V/m) are this rank's columns: (p of the columns, the label's logit,
    the sums of each of ``extra`` (tensors like ``a``) weighted by p, and
    each one's label entry), with one ``all_reduce`` for the max and one
    for every sum."""
    mx = tp.all_reduce(a.amax(-1), shard.group, dist.ReduceOp.MAX)
    e = torch.exp(a - mx[..., None])
    col, inside = _owner(y, shard)

    def at_label(t):
        return torch.where(inside, torch.gather(t, -1, col[..., None])[..., 0],
                           t.new_zeros(()))

    parts = [e.sum(-1), at_label(a)]
    for t in extra:
        parts += [(e * t).sum(-1), at_label(t)]
    sums = tp.all_reduce(torch.stack(parts), shard.group)
    se = sums[0]
    p = e / se[..., None]
    lse = mx + torch.log(se)
    return p, lse, sums[1], [(sums[2 + 2 * j] / se, sums[3 + 2 * j])
                             for j in range(len(extra))]


def _shard_grad_logits(p, y, shard, scale):
    """(p - onehot(y)) * scale on this rank's columns."""
    col, inside = _owner(y, shard)
    g = p.scatter_add(-1, col[..., None], -inside[..., None].to(p.dtype))
    return g * scale


class _CECore(torch.autograd.Function):
    """Sum of token NLLs, streamed over T chunks.  The backward recomputes
    each chunk's softmax instead of saving it (the reference's
    ``custom_vjp``); reverse mode only.  ``shard``: the vocabulary slice
    of W's columns (``tensor_parallel.VocabShard``), or None (whole)."""

    @staticmethod
    def forward(ctx, hidden, W, labels, t_chunk: int, shard):
        tc = _chunks(hidden.shape[1], t_chunk)
        Wc = W.to(hidden.dtype)
        nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, hidden.shape[1], tc):
            a = (hidden[:, i:i + tc] @ Wc).float()
            if shard is not None:
                _, lse, ay, _ = _shard_softmax(a, labels[:, i:i + tc], shard)
                nll = nll + (lse - ay).sum()
                continue
            lp = torch.log_softmax(a, -1)
            y = labels[:, i:i + tc, None].long()
            nll = nll + (-torch.gather(lp, -1, y)).sum()
        ctx.save_for_backward(hidden, W, labels)
        ctx.tc, ctx.shard = tc, shard
        return nll

    @staticmethod
    def backward(ctx, ct):
        hidden, W, labels = ctx.saved_tensors
        tc, shard = ctx.tc, ctx.shard
        Wc = W.to(hidden.dtype)
        cot_h = torch.zeros_like(hidden)
        cot_W = torch.zeros(W.shape, dtype=torch.float32, device=W.device)
        for i in range(0, hidden.shape[1], tc):
            h = hidden[:, i:i + tc]
            a, y = (h @ Wc).float(), labels[:, i:i + tc]
            if shard is None:
                g = _grad_logits(a, y, ct)
            else:
                g = _shard_grad_logits(_shard_softmax(a, y, shard)[0], y,
                                       shard, ct)
            cot_h[:, i:i + tc] = g.to(hidden.dtype) @ Wc.T
            cot_W += torch.einsum("btd,btv->dv", h.float(), g)
        return cot_h, cot_W.to(W.dtype), None, None, None


def _tokens(batch, hidden):
    """The token count the means divide by: the global one under
    ``batch["norms"]``, else the batch's own B·T."""
    norms = batch.get("norms")
    return hidden.shape[0] * hidden.shape[1] if norms is None \
        else norms["tokens"]


def _argmax(a, shard):
    """The argmax over the whole vocabulary of logits of which ``a`` are
    this rank's columns (``shard``; None: all of them), the lowest index
    of a tie, as ``torch.argmax``."""
    if shard is None:
        return a.argmax(-1)
    ix = a.argmax(-1)
    best = torch.gather(a, -1, ix[..., None])[..., 0]
    top = tp.all_reduce(best, shard.group, dist.ReduceOp.MAX)
    ix = torch.where(best == top, ix + shard.start,
                     torch.full_like(ix, torch.iinfo(ix.dtype).max))
    return tp.all_reduce(ix, shard.group, dist.ReduceOp.MIN)


class ChunkedCELoss:
    """out = (hidden (B,T,d), head (d,V)); batch["labels"]: (B,T)."""

    name = "chunked_ce"

    def __init__(self, t_chunk: int = 256):
        self.t_chunk = t_chunk

    def normalisers(self, batch) -> dict:
        """The counts ``value`` and the factors divide by, over this
        batch (a rank's share): its tokens."""
        labels = batch["labels"]
        return {"tokens": torch.tensor(float(labels.numel()),
                                       device=labels.device)}

    # --- loss ---------------------------------------------------------------
    def value(self, out, batch, accumulators: str = "full"
              ) -> Tuple[torch.Tensor, dict]:
        """(mean token NLL, {"ce", "acc"}).  ``accumulators`` is part of
        the loss-spec interface (the lattice losses elide statistics in
        "loss_only" mode); CE is value-only already."""
        hidden, W = out
        T = hidden.shape[1]
        N = _tokens(batch, hidden)
        labels = batch["labels"]
        shard = tp.vocab_shard(W.shape[1])
        nll = _CECore.apply(hidden, W, labels, self.t_chunk, shard)
        tc = _chunks(T, self.t_chunk)
        correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
        with torch.no_grad():
            Wc = W.detach().to(hidden.dtype)
            for i in range(0, T, tc):
                a = hidden[:, i:i + tc].detach() @ Wc
                correct += (_argmax(a, shard) == labels[:, i:i + tc]).sum()
        loss = nll / N
        return loss, {"ce": loss, "acc": correct.float() / N}

    # --- curvature factors --------------------------------------------------
    def _factor(self, out, batch, u, kind: str):
        hidden, W = out
        u_h, u_W = u
        T = hidden.shape[1]
        N = _tokens(batch, hidden)
        w = 1.0 / N
        tc = _chunks(T, self.t_chunk)
        labels = batch["labels"]
        shard = tp.vocab_shard(W.shape[1])
        Wf, uWf = W.float(), u_W.float()
        cot_h = torch.zeros_like(hidden)
        cot_W = torch.zeros(W.shape, dtype=torch.float32, device=W.device)
        for i in range(0, T, tc):
            hf = hidden[:, i:i + tc].float()
            a = hf @ Wf
            ja = u_h[:, i:i + tc].float() @ Wf + hf @ uWf
            if shard is not None:
                y = labels[:, i:i + tc]
                p, _, _, [(pu, ja_y)] = _shard_softmax(a, y, shard, [ja])
                if kind == "gn":
                    fa = w * (p * ja - p * pu[..., None])
                else:   # ĝᵀja = w (pᵀja - ja_y)
                    g = _shard_grad_logits(p, y, shard, w)
                    fa = N * g * (w * (pu - ja_y))[..., None]
                cot_h[:, i:i + tc] = (fa @ Wf.T).to(hidden.dtype)
                cot_W += torch.einsum("btd,btv->dv", hf, fa)
                continue
            p = torch.softmax(a, -1)
            if kind == "gn":
                pu = torch.sum(p * ja, -1, keepdim=True)
                fa = w * (p * ja - p * pu)
            else:  # empirical Fisher, S = N atoms
                g = _grad_logits(a, labels[:, i:i + tc], w)
                gu = torch.sum(g * ja, -1, keepdim=True)
                fa = N * g * gu
            cot_h[:, i:i + tc] = (fa @ Wf.T).to(hidden.dtype)
            cot_W += torch.einsum("btd,btv->dv", hf, fa)
        return cot_h, cot_W.to(W.dtype)

    def gn_vp(self, out, batch, u):
        return self._factor(out, batch, u, "gn")

    def fisher_vp(self, out, batch, u):
        return self._factor(out, batch, u, "fisher")
