"""repro_torch.analysis: the port's static and dynamic checks.

Port of ``repro.analysis``, two of its three pillars:

  * **Kernel sanitizer** (``sanitize_kernels`` + ``rules_kernel`` +
    ``corpus``, with the capture hook ``kernels.instrument``): runs every
    kernel wrapper over the adversarial lattice corpus and small vector
    shapes, f32 and bf16, on the card (or on the CPU through the plain
    versions), captures each launch and checks KS001 launch structure
    (threads, shared bytes against ptxas's static shared memory,
    ``gstride``, grid, the attention's tile geometry), KS002 frontier
    invariants, KS003 gather bounds of the captured index operands, KS004
    agreement with ``kernels/ref.py`` and finiteness, and KS005 precision
    flow; seeded mutants prove the rules fire.

  * **reprolint** (``lint`` + ``rules_ast``): an AST pass over
    ``src/repro_torch`` in torch's idiom: no host numpy (RL001), host
    sync (RL002) or Python branch on a device value (RL003) on the device
    path; every launching kernel wrapper paired with its plain version
    and a test, every CUDA source with a launch (RL004); every
    ``autograd.Function`` with a backward and every ``custom_op`` with a
    fake (RL005); no raw logsumexp/softmax in the lattice engine (RL006);
    no float64 requests (RL007).

Run them:

    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.sanitize_kernels [--device cpu] [--self-test]

The reference's third pillar, its graph auditor over XLA's HLO, has no
counterpart yet (ROADMAP 1.5.3), and with it the combined runner
``python -m repro.analysis``.
"""
