"""The MoE archs on a card: both expert FFNs at granite-moe-3b-a800m's full
width against the same calls on the CPU, the sliding-window attention
kernels at mixtral-8x22b's head geometry against their plain version,
the smoke models' prefill and decode against the CPU's, and mixtral's
training through the attention's derivative kernels.

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so they run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_moe.py

Tolerances: the FFNs and the smoke models at f32 compute (TF32 off)
within relative L2 1e-5 of the CPU (the same f32 arithmetic, sums in
another order; the card's ``index_add`` adds with atomics, so its
dispatch output is not bitwise repeatable); the same top-k sets on both.
The attention kernels against their plain version as
``tests/test_torch_cuda_lm.py``: f32 |d| <= 2e-5 + 2e-5 |plain|; bf16 one
ulp, 1e-4 + 2^-7 |plain|, and at most 1 % of the entries differing.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

GRANITE, MIXTRAL = "granite-moe-3b-a800m", "mixtral-8x22b"
F32_L2 = 1e-5
TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}
BF16_DIFF_SHARE = 0.01


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return resolve_device("cuda")


def _l2(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("fn", ["moe_apply", "moe_apply_dispatch"])
def test_moe_ffn_at_full_width_matches_the_cpu(cuda, fn):
    """One layer's FFN at granite's full width (d 1536, 40 experts of ff
    512, top-8), B 2 x T 256, f32: output and aux as the CPU's."""
    cfg = get_config(GRANITE).replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = L.init_moe(cfg, L.Init("cpu", gen))
    x = torch.randn(2, 256, cfg.d_model, generator=gen)
    want, waux = getattr(L, fn)(cfg, p, x)
    pg = {k: v.to(cuda) for k, v in p.items()}
    got, aux = getattr(L, fn)(cfg, pg, x.to(cuda))
    assert got.device.type == "cuda" and _l2(got, want) < F32_L2
    assert abs(float(aux) - float(waux)) <= F32_L2 * float(waux)
    ix_cpu = torch.sort(L._route(cfg, p, x)[2], -1).values
    ix_gpu = torch.sort(L._route(cfg, pg, x.to(cuda))[2], -1).values
    assert torch.equal(ix_gpu.cpu(), ix_cpu)


def _qkv(dev, B, T, H, K, hd, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, T, h, hd, generator=gen, device=dev).to(dtype)
            for h in (H, K, K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_at_mixtral_geometry(cuda, dtype):
    """H 48 / K 8 (G = 6: the tensor-core kernel's tiles of 21 queries x
    6 heads), hd 128, window 4096, T 8192 (the band matters)."""
    q, k, v = _qkv(cuda, 1, 8192, 48, 8, 128, dtype, seed=6)
    n = (SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches)
    got = SWA.swa_attention(q, k, v, 4096)
    again = SWA.swa_attention(q, k, v, 4096)
    want = R.swa_attention_ref(q, k, v, 4096)
    torch.cuda.synchronize()
    tc = 2 if dtype == torch.bfloat16 else 0
    assert (SWA.swa_attention.launches,
            SWA.swa_attention.cuda_core_launches) == (n[0] + tc,
                                                      n[1] + 2 - tc)
    atol, rtol = TOL[dtype]
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if dtype == torch.bfloat16:
        assert float((got != want).float().mean()) <= BF16_DIFF_SHARE
    assert torch.equal(got, again)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
@pytest.mark.parametrize("arch", [GRANITE, MIXTRAL])
def test_smoke_forward_and_decode_match_the_cpu(cuda, arch, impl):
    """The smoke model at f32 compute: prefill (mixtral's windowed layers
    through the CUDA-core kernel, once a layer) and 24 decode steps (the
    dense FFN, mixtral's 16-slot ring wrapping) as the CPU's."""
    cfg = get_config(arch).smoke().replace(compute_dtype="float32",
                                           moe_impl=impl)
    model = get_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = {k: v.to(cuda) for k, v in p_cpu.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    prefill = build_prefill_step(cfg)
    n = SWA.swa_attention.cuda_core_launches
    got = prefill(p_gpu, {"tokens": toks.to(cuda)})
    torch.cuda.synchronize()
    assert SWA.swa_attention.cuda_core_launches - n == (
        cfg.num_layers if arch == MIXTRAL else 0)
    assert _l2(got, prefill(p_cpu, {"tokens": toks})) < F32_L2
    step = build_serve_step(cfg)
    c_cpu = model.init_cache(2, 32, device="cpu")
    c_gpu = model.init_cache(2, 32, device=cuda)
    for t in range(24):
        lc, c_cpu = step(p_cpu, c_cpu, toks[:, t:t + 1], t)
        lg, c_gpu = step(p_gpu, c_gpu, toks[:, t:t + 1].to(cuda), t)
        assert _l2(lg, lc) < F32_L2, t


def test_mixtral_training_meets_the_autograd_guard(cuda):
    """An NGHF step of mixtral's smoke model on the card: the gradient
    stage differentiates through the windowed attention, which met an
    autograd guard until its derivative kernels were written (ROADMAP
    1.3.3); now the step runs through them (the dq, dk/dv and jvp kernels
    launch) with finite metrics, as granite's does without them."""
    for arch in (MIXTRAL, GRANITE):
        cfg = get_config(arch).smoke()
        params = get_model(cfg).init(0, device=cuda)
        step, opt = build_step(cfg, "nghf", cg_frac=4, cg_iters=2,
                               ng_iters=1)
        batch = lm_batch(0, batch=4, seq_len=32, vocab=cfg.vocab_size,
                         device=cuda)
        n = (SWA.swa_attention_vjp.dkdv_launches,
             SWA.swa_attention_jvp.launches)
        _, _, m = step(params, opt.init(params), batch)
        torch.cuda.synchronize()
        assert all(torch.isfinite(torch.as_tensor(v)).all()
                   for v in m.values())
        launched = (SWA.swa_attention_vjp.dkdv_launches > n[0],
                    SWA.swa_attention_jvp.launches > n[1])
        assert launched == ((True, True) if arch == MIXTRAL
                            else (False, False))
