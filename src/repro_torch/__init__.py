"""PyTorch + CUDA port of the NGHF reproduction (``repro``), slice by slice.

The JAX package ``repro`` stays the reference; this package mirrors its
module layout so that each port module's counterpart is found by name
(``repro_torch.lattice_engine.levelized`` <-> ``repro.lattice_engine.
levelized``).  It never imports ``jax`` or ``repro``.

Slice 1 is the lattice-rescoring service, slice 2 NGHF sequence training:

  * ``losses.lattice``      — ``Lattice``, frontier tensors, numpy builders
  * ``losses.sequence``     — CE / MMI / MPE loss specs with curvature
                              factors
  * ``lattice_engine``      — differentiable ``lattice_stats`` over the
                              plain levelized backend and the CUDA kernel
                              backend (sausage and DAG kernels)
  * ``kernels``             — the hand-written Hopper kernels
                              (``csrc/*.cu``), their wrappers and their
                              plain PyTorch versions (``ref``)
  * ``models.acoustic``     — the paper's RNN / LSTM / TDNN
  * ``core``                — theta-vector helpers, CG, curvature
                              products, the optimiser registry, the
                              collectives of a mesh run
  * ``data.synthetic``      — seeded synthetic ASR batches
  * ``data.pipeline``       — each rank's share of a batch, prefetch
  * ``launch``              — the sequence step builder and the training
                              driver (``launch.train.train_sequence``);
                              meshes of ranks (``launch.mesh``) and the
                              sharding rules (``launch.sharding``)
  * ``serving``             — bucket packing, the batched service and the
                              streaming alpha-resume session
  * ``analysis.corpus``     — the adversarial lattice corpus
  * ``convert``             — carries JAX-side lattices, stream
                              checkpoints and acoustic parameters (as
                              numpy) into the port

Entry points take ``device=`` and default to ``"cuda"``; see ``device``.
"""
