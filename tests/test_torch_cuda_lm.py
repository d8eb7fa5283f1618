"""The port's LM serving path on a card: the sliding-window attention
kernels against their plain version, and the smoke recurrentgemma-9b
through the kernel against the plain path on the CPU.

bf16 inputs go to the tensor-core kernel (``csrc/swa_attention_sm90.cu``,
counted by ``swa_attention.launches``), f32 inputs to the CUDA-core
kernel (``csrc/swa_attention.cu``, ``swa_attention.cuda_core_launches``).

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so they run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_lm.py

Tolerances against the plain version on the same inputs, |d| <= atol +
rtol |plain|: f32 2e-5 and 2e-5 (the same f32 arithmetic, sums in another
order); bf16 1e-4 and 2^-7, one bf16 ulp (both round to bf16 f32 values
that differ in the last f32 bits), and at most 1 % of the bf16 entries
differ at all (a P rounded to bf16 before P.V makes about 40 % differ).
A repeat launch is bitwise equal (no atomics).
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import swa_attention as SWA  # noqa: E402
from repro_torch.launch.serve import make_requests, serve  # noqa: E402
from repro_torch.launch.steps import build_prefill_step  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-4, 2.0 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(dev, B, T, H, K, hd, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, T, h, hd, generator=gen, device=dev).to(dtype)
            for h in (H, K, K)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,K,hd,window", [
    (1, 1, 4, 4, 64, 16),          # T = 1
    (2, 100, 4, 1, 64, 128),       # T <= window, MQA
    (2, 333, 8, 2, 128, 64),       # ragged T, GQA
    (1, 200, 2, 2, 256, 0),        # window 0: the diagonal only
    (1, 300, 4, 4, 32, 1000),      # window past T, hd 32 (padded to 64)
    (1, 513, 4, 4, 80, 96),        # hd 80 (padded to 128)
    (2, 1000, 16, 1, 256, 200),    # recurrentgemma's heads, short window
])
def test_kernel_matches_plain_version(cuda, B, T, H, K, hd, window, dtype):
    q, k, v = _qkv(cuda, B, T, H, K, hd, dtype, seed=T + hd)
    counts = _counts()
    got = SWA.swa_attention(q, k, v, window)
    again = SWA.swa_attention(q, k, v, window)
    want = R.swa_attention_ref(q, k, v, window)
    torch.cuda.synchronize()
    tc = 2 if dtype == torch.bfloat16 else 0
    assert _counts() == (counts[0] + tc, counts[1] + 2 - tc)
    _check(got, want, again, dtype, (B, T, H, hd))


def _counts():
    return SWA.swa_attention.launches, SWA.swa_attention.cuda_core_launches


def _check(got, want, again, dtype, shape):
    assert got.dtype == dtype and got.shape == shape
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    if dtype == torch.bfloat16:
        assert float((got != want).float().mean()) <= 0.01
    assert torch.equal(got, again)


# the tensor-core kernel's tiles: G = H // K heads per kv head in
# {1, 2, 3, 16} (128 queries x 1 head, 64 x 2, 42 x 3 with two rows
# masked, 8 x 16), ragged T around a tile's 8 queries, window 0, a
# window inside T and one past it; hd cycles through 64, 80, 128, 256
_TC_CASES = [(B, T, G * K, K, (64, 80, 128, 256)[i % 4], w)
             for i, (B, K, G, T) in enumerate(
                 (B, K, G, T) for B, K in ((1, 1), (2, 2))
                 for G in (1, 2, 3, 16) for T in (1, 7, 8, 9, 4100))
             for w in (0, 37, T + 5)]


@pytest.mark.parametrize("B,T,H,K,hd,window", _TC_CASES + [
    (1, 4100, 16, 1, hd, 2048) for hd in (64, 80, 128, 256)] + [
    (1, 9, 130, 1, 64, 4),         # G > 128: two head tiles
])
def test_tensor_core_kernel_matches_plain_version(cuda, B, T, H, K, hd,
                                                  window):
    q, k, v = _qkv(cuda, B, T, H, K, hd, torch.bfloat16, seed=T + H + hd)
    counts = _counts()
    got = SWA.swa_attention(q, k, v, window)
    again = SWA.swa_attention(q, k, v, window)
    want = R.swa_attention_ref(q, k, v, window)
    torch.cuda.synchronize()
    assert _counts() == (counts[0] + 2, counts[1])
    _check(got, want, again, torch.bfloat16, (B, T, H, hd))


def test_routing_by_dtype_and_head_dim(cuda):
    """bf16 (hd % 8 == 0) to the tensor-core kernel, f32 and bf16 with
    hd % 8 != 0 to the CUDA-core kernel; CPU tensors to neither."""
    for dtype, hd, tc in ((torch.bfloat16, 64, 1), (torch.float32, 64, 0),
                          (torch.bfloat16, 36, 0)):
        q, k, v = _qkv(cuda, 1, 40, 4, 2, hd, dtype)
        counts = _counts()
        got = SWA.swa_attention(q, k, v, 16)
        torch.cuda.synchronize()
        assert _counts() == (counts[0] + tc, counts[1] + 1 - tc)
        want = R.swa_attention_ref(q, k, v, 16)
        atol, rtol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    counts = _counts()
    SWA.swa_attention(q.cpu(), k.cpu(), v.cpu(), 16)
    assert _counts() == counts


def test_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 2, 1, 32, torch.float32)
    with pytest.raises(NotImplementedError, match="q_offset"):
        SWA.swa_attention(q, k, v, 8, q_offset=4)
    with pytest.raises(TypeError, match="float16"):
        SWA.swa_attention(q.half(), k.half(), v.half(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        SWA.swa_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v, 8)
    big = _qkv(cuda, 1, 8, 1, 1, 320, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        SWA.swa_attention(*big, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_refuse_autograd(cuda, dtype):
    """The kernels refused autograd until their derivatives were written
    (ROADMAP 1.3.3); now gradients flow.  With autograd on and inputs that
    require grad, ``swa_attention`` (both routes) and
    ``cuda_core_swa_attention`` launch their forward kernel, and a backward
    launches the dq and dk/dv kernels once each (bf16 the tensor-core pair,
    f32 the CUDA-core pair, whatever the forward), with gradients equal to
    the plain version's (f32 relative L2 1e-5; bf16 within 1.5 x the
    plain bf16 gradient's distance from the f32 one); under
    ``torch.no_grad`` the same inputs give the same bits and no graph."""
    q, k, v = _qkv(cuda, 1, 40, 4, 2, 64, dtype)
    g = torch.randn_like(q)
    plain = R.swa_attention_vjp_ref(q, k, v, g, 16)
    plain32 = R.swa_attention_vjp_ref(q.float(), k.float(), v.float(),
                                      g.float(), 16)
    tc = int(dtype == torch.bfloat16)
    for fn, core in ((SWA.swa_attention, 1 - tc),
                     (SWA.cuda_core_swa_attention, 1)):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        counts = _counts()
        f = SWA.swa_attention_vjp
        bwd = (f.dq_launches, f.dkdv_launches, f.cuda_core_dq_launches,
               f.cuda_core_dkdv_launches)
        out = fn(*leaves, 16)
        assert out.grad_fn is not None
        out.backward(g)
        torch.cuda.synchronize()
        assert _counts() == (counts[0] + 1 - core, counts[1] + core)
        # the backward routes by dtype alone: bf16 to the tensor-core pair
        assert (f.dq_launches, f.dkdv_launches, f.cuda_core_dq_launches,
                f.cuda_core_dkdv_launches) == (bwd[0] + tc, bwd[1] + tc,
                                               bwd[2] + 1 - tc,
                                               bwd[3] + 1 - tc)
        for x, p, p32 in zip(leaves, plain, plain32):
            err = float((x.grad.float() - p32.float()).norm() / p32.norm())
            if dtype == torch.float32:
                assert err <= 1e-5
            else:
                assert err <= 1.5 * float((p.float() - p32).norm()
                                          / p32.norm())
        with torch.no_grad():
            quiet = fn(*leaves, 16)
        assert quiet.grad_fn is None and torch.equal(quiet, out.detach())


def test_smoke_prefill_and_serve_on_the_card_match_the_cpu(cuda):
    """The smoke model at f32 compute: prefill through the kernel (one
    launch for its one local layer) against the CPU's plain path, and
    greedy serving token for token."""
    cfg = get_config("recurrentgemma-9b").smoke().replace(
        compute_dtype="float32")
    model = get_model(cfg)
    params = model.init(0, device=cuda)
    cpu = {k: v.cpu() for k, v in params.items()}
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), generator=gen)
    step = build_prefill_step(cfg)
    n = SWA.swa_attention.cuda_core_launches
    got = step(params, {"tokens": tokens.to(cuda)})
    torch.cuda.synchronize()
    assert SWA.swa_attention.cuda_core_launches == n + 1
    want = step(cpu, {"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    reqs_gpu, _ = serve(cfg, model, params, make_requests(cfg, 3, 6))
    reqs_cpu, _ = serve(cfg, model, cpu, make_requests(cfg, 3, 6))
    assert [r.generated for r in reqs_gpu] == [r.generated for r in reqs_cpu]
