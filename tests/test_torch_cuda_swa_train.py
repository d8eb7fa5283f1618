"""The windowed attention's derivative kernels on a card: the backward's
dq and dk/dv kernels (``swa_attention_vjp``) and the jvp kernel
(``swa_attention_jvp``), each on both routes (bf16 with hd % 8 == 0 on the
tensor cores, ``csrc/swa_attention_bwd_sm90.cu``; f32 and ``core=True``
on the CUDA cores, ``csrc/swa_attention_bwd.cu``; each route counted
apart), against their plain versions (``kernels.ref.swa_attention_vjp_ref``
and ``swa_attention_jvp_ref``) on adversarial shapes and both training
shapes, bitwise on a repeat, misaligned inputs refused; the no-grad
forward through the autograd Function bitwise equal to the direct launch;
``torch.func.linearize``'s tangent at two vectors; second order raising;
and the smoke models' curvature products and SGD step through the
kernels against the CPU's plain path.

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_swa_train.py

Limits, per output tensor: f32 relative L2 1e-5 against the plain version
(the same f32 arithmetic, sums in another order); bf16 no farther, in
relative L2, from the plain version on the inputs upcast to f32 than the
plain version in bf16 is, times 1.5 (the rule of ``chip_smoke.py``'s
logits check), plus 1e-6.  No atomics, so a repeat launch is bitwise equal.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.curvature import make_curvature_ops  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402
from repro_torch.launch.steps import build_step, lm_forward  # noqa: E402
from repro_torch.losses.chunked_lm import ChunkedCELoss  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

F32_REL_L2 = 1e-5
BF16_FACTOR = 1.5
# added to the bf16 limit: where the plain bf16 result is exact (window
# 0's tangent is tv itself), the kernel keeps only its f32 sums' rounding
BF16_FLOOR = 1e-6
# (B, T, H, K, hd, window): T = 1, T <= window, ragged T, window 0, a window
# past T, MHA/GQA/MQA, hd 32-256, G = H / K of 1, 2, 3, 4 and 16
CASES = [
    (1, 1, 4, 4, 64, 16),
    (2, 100, 4, 1, 64, 128),
    (2, 333, 8, 2, 128, 64),
    (1, 200, 2, 2, 256, 0),
    (1, 300, 4, 4, 32, 1000),
    (1, 513, 4, 4, 80, 96),
    (1, 300, 6, 2, 64, 37),
    (2, 9, 32, 2, 256, 100),
    (1, 1100, 16, 1, 256, 200),
]
# phase 13's bf16 shapes (chip_smoke.py SWA_CASES): G = 1, 2, 3, 4 and 16,
# T from 1 to 4100, windows 0 to past T; recurrentgemma-9b's training shape
# and mixtral-8x22b's geometry (G = 6)
BF16_CASES = [
    (1, 513, 4, 4, 80, 96),
    (2, 1000, 16, 1, 256, 200),
    (1, 4100, 16, 1, 256, 2048),
    (1, 1, 4, 4, 64, 16),
    (1, 7, 16, 1, 128, 0),
    (2, 9, 32, 2, 256, 100),
    (1, 300, 6, 2, 64, 37),
    (2, 333, 8, 4, 128, 64),
    (1, 200, 2, 2, 256, 0),
    (2, 100, 4, 1, 64, 128),
]
TRAIN_CASES = [(2, 4096, 16, 1, 256, 2048), (1, 8192, 48, 8, 128, 4096)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, B, T, H, K, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, T, h, hd, generator=gen, device=dev).to(dtype)
            for h in (H, K, K, H, K, K, H)]


def _bwd_counts() -> tuple:
    """(tensor-core dq, dk/dv, CUDA-core dq, dk/dv) launches so far."""
    f = SWA.swa_attention_vjp
    return (f.dq_launches, f.dkdv_launches, f.cuda_core_dq_launches,
            f.cuda_core_dkdv_launches)


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    num = float(torch.linalg.vector_norm(a - b))
    den = float(torch.linalg.vector_norm(b))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def _check(tag, got, plain, plain32, dtype):
    """got and plain: the kernel's and the plain version's tensors in
    ``dtype``; plain32: the plain version on the inputs upcast to f32."""
    for name, a, p, p32 in zip(("dq", "dk", "dv", "dO"), got, plain,
                               plain32):
        assert a.dtype == dtype and a.shape == p.shape, (tag, name)
        assert bool(torch.isfinite(a).all()), (tag, name)
        if dtype == torch.float32:
            assert _rel_l2(a, p) <= F32_REL_L2, (tag, name, _rel_l2(a, p))
        else:
            limit = BF16_FACTOR * _rel_l2(p, p32) + BF16_FLOOR
            assert _rel_l2(a, p32) <= limit, (tag, name, _rel_l2(a, p32),
                                              limit)


@pytest.mark.parametrize("core", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,K,hd,window",
                         CASES + BF16_CASES + TRAIN_CASES)
def test_backward_kernels_match_plain_version(cuda, B, T, H, K, hd, window,
                                              dtype, core):
    """bf16 (hd % 8 == 0) launches the tensor-core pair, f32 and ``core``
    the CUDA-core pair, each seen on its own counters."""
    q, k, v, _, _, _, g = _inputs(cuda, B, T, H, K, hd, dtype, T + hd)
    n = _bwd_counts()
    got = SWA.swa_attention_vjp(q, k, v, g, window, core=core)
    again = SWA.swa_attention_vjp(q, k, v, g, window, core=core)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and hd % 8 == 0 and not core)
    assert _bwd_counts() == (n[0] + 2 * tc, n[1] + 2 * tc,
                             n[2] + 2 * (1 - tc), n[3] + 2 * (1 - tc))
    plain = R.swa_attention_vjp_ref(q, k, v, g, window)
    plain32 = R.swa_attention_vjp_ref(*(x.float() for x in (q, k, v, g)),
                                      window)
    _check((B, T, H, K, hd, window), got, plain, plain32, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,T,H,K,hd,window", TRAIN_CASES)
def test_tensor_core_backward_repeats_its_bits(cuda, B, T, H, K, hd,
                                               window):
    """No atomics and sums in a fixed order: three launches of each
    tensor-core kernel give the same bits."""
    q, k, v, _, _, _, g = _inputs(cuda, B, T, H, K, hd, torch.bfloat16, 7)
    outs = [SWA.launch_dq(q, k, v, g, window) for _ in range(3)]
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    _, lse, dd = outs[0]
    assert lse.shape == dd.shape == (B, K, T, H // K)
    grads = [SWA.launch_dkdv(q, k, v, g, lse, dd, window) for _ in range(3)]
    torch.cuda.synchronize()
    for o in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, grads[0]))


def test_tensor_core_backward_refuses_misaligned_inputs(cuda):
    q, k, v, _, _, _, g = _inputs(cuda, 1, 64, 4, 1, 64, torch.bfloat16, 8)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        SWA.swa_attention_vjp(shifted, k, v, g, 16)


def _jvp_counts() -> tuple:
    """(tensor-core, CUDA-core) jvp launches so far."""
    f = SWA.swa_attention_jvp
    return f.launches, f.cuda_core_launches


@pytest.mark.parametrize("core", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,K,hd,window",
                         CASES + BF16_CASES + TRAIN_CASES)
def test_jvp_kernel_matches_plain_version(cuda, B, T, H, K, hd, window,
                                          dtype, core):
    """bf16 (hd % 8 == 0) launches the tensor-core jvp, f32 and ``core``
    the CUDA-core one, each seen on its own counter."""
    q, k, v, tq, tk, tv, _ = _inputs(cuda, B, T, H, K, hd, dtype, T + H)
    n = _jvp_counts()
    got = SWA.swa_attention_jvp(q, k, v, tq, tk, tv, window, core=core)
    again = SWA.swa_attention_jvp(q, k, v, tq, tk, tv, window, core=core)
    torch.cuda.synchronize()
    tc = int(dtype == torch.bfloat16 and hd % 8 == 0 and not core)
    assert _jvp_counts() == (n[0] + 2 * tc, n[1] + 2 * (1 - tc))
    plain = R.swa_attention_jvp_ref(q, k, v, tq, tk, tv, window)
    plain32 = R.swa_attention_jvp_ref(
        *(x.float() for x in (q, k, v, tq, tk, tv)), window)
    _check((B, T, H, K, hd, window), [got], [plain], [plain32], dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("B,T,H,K,hd,window", TRAIN_CASES)
def test_tensor_core_jvp_repeats_its_bits(cuda, B, T, H, K, hd, window):
    """No atomics and sums in a fixed order: three launches of the
    tensor-core jvp give the same bits."""
    q, k, v, tq, tk, tv, _ = _inputs(cuda, B, T, H, K, hd, torch.bfloat16,
                                     9)
    n = _jvp_counts()
    outs = [SWA.swa_attention_jvp(q, k, v, tq, tk, tv, window)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert _jvp_counts() == (n[0] + 3, n[1])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_tensor_core_jvp_refuses_misaligned_inputs(cuda):
    q, k, v, tq, tk, tv, _ = _inputs(cuda, 1, 64, 4, 1, 64, torch.bfloat16,
                                     8)
    flat = torch.empty(tk.numel() + 1, dtype=tk.dtype, device=cuda)
    shifted = flat[1:].view(tk.shape)
    shifted.copy_(tk)
    with pytest.raises(ValueError, match="16-byte aligned"):
        SWA.swa_attention_jvp(q, k, v, tq, shifted, tv, 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_forward_is_the_direct_launch(cuda, dtype):
    """Under ``torch.no_grad`` and under autograd the Function's output is
    bitwise the forward kernel's direct launch; gradients then flow
    through the backward kernels to all three inputs."""
    q, k, v, _, _, _, g = _inputs(cuda, 2, 300, 8, 2, 128, dtype, 1)
    direct = SWA._forward(q, k, v, 64, False)
    with torch.no_grad():
        quiet = SWA.swa_attention(q, k, v, 64)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = SWA.swa_attention(*leaves, 64)
    assert torch.equal(quiet, direct) and torch.equal(out.detach(), direct)
    out.backward(g)
    want = SWA.swa_attention_vjp(q, k, v, g, 64)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linearize_tangent_at_two_vectors(cuda, dtype):
    """``torch.func.linearize`` records the jvp kernel's launch: its
    tangent at two different vectors matches the plain version's.  f32
    launches the CUDA-core jvp, bf16 the tensor-core one and never the
    CUDA-core one."""
    q, k, v, tq, tk, tv, _ = _inputs(cuda, 1, 200, 4, 1, 64, dtype, 2)

    def f(a, b, c):
        return SWA.swa_attention(a, b, c, 37)

    _, jvp_fn = torch.func.linearize(f, q, k, v)
    n = _jvp_counts()
    for scale in (1.0, -3.0):
        t = (scale * tq, tk.flip(1), scale * tv)
        got = jvp_fn(*t)
        direct = torch.func.jvp(f, (q, k, v), t)[1]
        want = R.swa_attention_jvp_ref(q, k, v, *t, 37)
        want32 = R.swa_attention_jvp_ref(
            *(x.float() for x in (q, k, v) + t), 37)
        _check(scale, [got], [want], [want32], dtype)
        _check(scale, [direct], [want], [want32], dtype)
    tc = int(dtype == torch.bfloat16)
    assert _jvp_counts() == (n[0] + 4 * tc, n[1] + 4 * (1 - tc))


def test_second_order_raises(cuda):
    q, k, v, tq, _, _, g = _inputs(cuda, 1, 64, 2, 1, 32, torch.float32, 3)

    def f(x):
        return SWA.swa_attention(x, k, v, 8)

    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.func.jvp(lambda x: torch.func.vjp(f, x)[1](g)[0], (q,), (tq,))
    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.func.vjp(lambda x: torch.func.jvp(f, (x,), (tq,))[1], q)[1](g)
    # a backward that would record its own graph (create_graph) raises
    x = q.detach().requires_grad_()
    with pytest.raises(NotImplementedError, match="first-order only"):
        torch.autograd.grad((f(x) * g).sum(), x, create_graph=True)


def _tree_rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].float().cpu() - b[k].float()) ** 2).sum())
              for k in b)
    den = sum(float((b[k].float() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mixtral-8x22b"])
def test_curvature_products_match_the_cpu(cuda, arch, compute):
    """The smoke model, T 48 past its window of 16: a GN product in each
    curvature mode (``linearize`` at two vectors) through the kernels on
    the card, against the plain path on the CPU.  f32 compute runs the
    CUDA-core jvp and backward, within 1e-4 of the CPU; bf16 the
    tensor-core jvp and backward and no CUDA-core kernel, no farther from
    the CPU's f32 product than the CPU's bf16 product is, x 1.5 (the
    kernels' rule), + 1e-6."""
    base = get_config(arch).smoke()
    cfg = base.replace(compute_dtype=compute)
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    batch = lm_batch(0, batch=2, seq_len=48, vocab=cfg.vocab_size,
                     device=cuda)
    batch = dict(batch, labels=batch["tokens"])
    loss = ChunkedCELoss()
    cpu = {k: v.cpu() for k, v in params.items()}
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    gen = torch.Generator().manual_seed(5)
    vecs = [{k: torch.randn(v.shape, generator=gen) for k, v in cpu.items()}
            for _ in range(2)]

    def cpu_products(c):
        ops = make_curvature_ops(lm_forward(c, get_model(c)), loss, cpu,
                                 cpu_batch)
        return [ops.gnvp(u) for u in vecs]

    want32 = cpu_products(base.replace(compute_dtype="float32"))
    want = cpu_products(cfg) if compute == "bfloat16" else want32
    fwd = lm_forward(cfg, model)
    for mode in ("rematvp", "linearize"):
        n = _jvp_counts() + _bwd_counts()
        ops = make_curvature_ops(fwd, loss, params, batch, mode=mode)
        for u, w, w32 in zip(vecs, want, want32):
            got = ops.gnvp({k: x.to(cuda) for k, x in u.items()})
            rel = _tree_rel_l2(got, w32)
            limit = (1e-4 if compute == "float32" else
                     BF16_FACTOR * _tree_rel_l2(w, w32) + BF16_FLOOR)
            assert rel <= limit, (mode, rel, limit)
        jvp, core_jvp, dq, dkdv, core_dq, core_dkdv = (
            now - then for now, then in zip(_jvp_counts() + _bwd_counts(),
                                            n))
        if compute == "float32":
            assert jvp == dq == dkdv == 0 and min(core_jvp, core_dkdv) > 0
        else:
            assert min(jvp, dq, dkdv) > 0
            assert core_jvp == core_dq == core_dkdv == 0


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mixtral-8x22b"])
def test_sgd_step_through_the_kernels(cuda, arch):
    """One SGD step of the smoke model in bf16 through ``build_step``:
    each windowed layer launches the forward and the tensor-core dq and
    dk/dv kernels once, and the CUDA-core backward never."""
    cfg = get_config(arch).smoke()
    params = get_model(cfg).init(0, device=cuda)
    step, opt = build_step(cfg, "sgd", lr=0.1)
    batch = lm_batch(0, batch=2, seq_len=48, vocab=cfg.vocab_size,
                     device=cuda)
    windowed = sum(kind in ("local", "swa", "swamoe")
                   for kind in (cfg.block_pattern * cfg.num_layers)
                   [:cfg.num_layers])
    SWA.reset_launch_counts()
    new, _, m = step(params, opt.init(params), batch)
    torch.cuda.synchronize()
    assert (SWA.swa_attention.launches,
            SWA.swa_attention_vjp.dq_launches,
            SWA.swa_attention_vjp.dkdv_launches) == (windowed,) * 3
    assert (SWA.swa_attention_vjp.cuda_core_dq_launches,
            SWA.swa_attention_vjp.cuda_core_dkdv_launches) == (0, 0)
    assert bool(torch.isfinite(torch.as_tensor(m["loss"])).all())
    assert any(not torch.equal(new[k], params[k]) for k in params)
