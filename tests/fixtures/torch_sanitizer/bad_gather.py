"""Seeded mutant of the port's kernel sanitizer: an off-by-one frontier
gather.

Shifts every predecessor position by one slot before calling the REAL
general-DAG forward wrapper, so the captured ``pidx`` reaches ``L*W +
1``, one past the dump slot at the end of the (L*W + 1,) frontier
buffer.  ``csrc/lattice_dag.cu`` reads such a position as an empty slot
(NEG / 0): the launch neither faults nor crashes, and logZ comes out
plausible and wrong.  KS003 on the captured operands must flag it
(``repro_torch.analysis.sanitize_kernels.self_test``).
"""
from repro_torch.kernels.lattice_fb import dag_forward


def bad_dag_forward(own, corr, start, ok, final, pidx):
    return dag_forward(own, corr, start, ok, final, pidx + 1)
