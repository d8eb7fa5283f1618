"""PyTorch + CUDA port of the NGHF reproduction (``repro``), slice by slice.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout so that each port module's counterpart is found by name
(``repro_torch.lattice_engine.levelized`` <-> ``repro.lattice_engine.
levelized``).  It never imports ``jax`` or ``repro``.

Slice 1 (this package so far) is the lattice-rescoring service:

  * ``losses.lattice``      — ``Lattice``, frontier tensors, numpy builders
  * ``lattice_engine``      — ``lattice_stats`` over the plain levelized
                              backend and the CUDA DAG-kernel backend
  * ``kernels``             — the hand-written Hopper kernels
                              (``csrc/lattice_dag.cu``), their wrappers and
                              their plain PyTorch versions (``ref``)
  * ``serving``             — bucket packing, the batched service and the
                              streaming alpha-resume session
  * ``analysis.corpus``     — the adversarial lattice corpus
  * ``convert``             — carries JAX-side lattices and stream
                              checkpoints (as numpy) into the port

Entry points take ``device=`` and default to ``"cuda"``; see ``device``.
"""
