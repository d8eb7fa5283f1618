"""Seeded mutant of the port's kernel sanitizer: bf16 loss-only sums.

A loss-only wrapper that hands its sums back in the input dtype instead
of f32: under bf16 log-probs logZ and the correctness average come back
with about 8 bits of mantissa, which poisons the NGHF line search that
compares candidate losses at small deltas.  KS005 (the wrapper run on
small real bf16 tensors) must flag it
(``repro_torch.analysis.sanitize_kernels.self_test``).
"""
from repro_torch.kernels.lattice_fb import sausage_loss_only


def bad_sausage_loss_only(log_probs, start, end, label, lm, corr, arc_mask,
                          level_arcs, *, kappa=1.0):
    logz, cavg = sausage_loss_only(log_probs, start, end, label, lm, corr,
                                   arc_mask, level_arcs, kappa=kappa)
    return logz.to(log_probs.dtype), cavg.to(log_probs.dtype)
