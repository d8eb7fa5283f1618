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
the batch's own B·T.
"""
from __future__ import annotations

from typing import Tuple

import torch


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


class _CECore(torch.autograd.Function):
    """Sum of token NLLs, streamed over T chunks.  The backward recomputes
    each chunk's softmax instead of saving it (the reference's
    ``custom_vjp``); reverse mode only."""

    @staticmethod
    def forward(ctx, hidden, W, labels, t_chunk: int):
        tc = _chunks(hidden.shape[1], t_chunk)
        Wc = W.to(hidden.dtype)
        nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, hidden.shape[1], tc):
            a = (hidden[:, i:i + tc] @ Wc).float()
            lp = torch.log_softmax(a, -1)
            y = labels[:, i:i + tc, None].long()
            nll = nll + (-torch.gather(lp, -1, y)).sum()
        ctx.save_for_backward(hidden, W, labels)
        ctx.tc = tc
        return nll

    @staticmethod
    def backward(ctx, ct):
        hidden, W, labels = ctx.saved_tensors
        tc = ctx.tc
        Wc = W.to(hidden.dtype)
        cot_h = torch.zeros_like(hidden)
        cot_W = torch.zeros(W.shape, dtype=torch.float32, device=W.device)
        for i in range(0, hidden.shape[1], tc):
            h = hidden[:, i:i + tc]
            g = _grad_logits((h @ Wc).float(), labels[:, i:i + tc], ct)
            cot_h[:, i:i + tc] = g.to(hidden.dtype) @ Wc.T
            cot_W += torch.einsum("btd,btv->dv", h.float(), g)
        return cot_h, cot_W.to(W.dtype), None, None


def _tokens(batch, hidden):
    """The token count the means divide by: the global one under
    ``batch["norms"]``, else the batch's own B·T."""
    norms = batch.get("norms")
    return hidden.shape[0] * hidden.shape[1] if norms is None \
        else norms["tokens"]


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
        nll = _CECore.apply(hidden, W, labels, self.t_chunk)
        tc = _chunks(T, self.t_chunk)
        correct = torch.zeros((), dtype=torch.int64, device=hidden.device)
        with torch.no_grad():
            Wc = W.detach().to(hidden.dtype)
            for i in range(0, T, tc):
                a = hidden[:, i:i + tc].detach() @ Wc
                correct += (a.argmax(-1) == labels[:, i:i + tc]).sum()
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
        Wf, uWf = W.float(), u_W.float()
        cot_h = torch.zeros_like(hidden)
        cot_W = torch.zeros(W.shape, dtype=torch.float32, device=W.device)
        for i in range(0, T, tc):
            hf = hidden[:, i:i + tc].float()
            a = hf @ Wf
            ja = u_h[:, i:i + tc].float() @ Wf + hf @ uWf
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
