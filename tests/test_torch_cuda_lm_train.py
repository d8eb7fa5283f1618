"""whisper-base training on a card: the fused CG update at whisper-base's
parameter count, and one smoke NGHF update on the card against the same
update on the CPU.

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so they run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_lm_train.py

Tolerances: ``cg_fused_update`` against its plain version, x and r
bitwise (the same two f32 roundings per element), ⟨r, r⟩ within 1e-6
relative (a fixed tile tree against PyTorch's sum), a repeat launch
bitwise.  The smoke update (f32 compute, TF32 off) makes the CPU's
decision (best iterate, acceptance, iterations), with candidate losses
within 1e-4 relative and Δθ within relative L2 1e-4, the bounds of the
CPU parity tests against the reference.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import cg_fused as CG  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.launch.steps import build_step, cg_sub_batch  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCH = "whisper-base"
N = 130_737_152
RR_RTOL = 1e-6
LOSS_RTOL = 1e-4
DELTA_REL_L2 = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cg_fused_update_at_whisper_base_size(cuda, dtype):
    assert get_model(get_config(ARCH)).param_count() == N
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, v, r, bv = (torch.randn(N, generator=gen, device=cuda).to(dtype)
                   for _ in range(4))
    alpha = torch.tensor(-0.61, device=cuda)
    n0 = CG.cg_fused_update.launches
    got = CG.cg_fused_update(alpha, x, v, r, bv)
    again = CG.cg_fused_update(alpha, x, v, r, bv)
    want = R.cg_fused_update_ref(alpha, x, v, r, bv)
    torch.cuda.synchronize()
    assert CG.cg_fused_update.launches == n0 + 2
    for g, w, a in zip(got[:2], want[:2], again[:2]):
        assert g.dtype == dtype and torch.equal(g, w) and torch.equal(g, a)
    assert abs(float(got[2]) - float(want[2])) <= RR_RTOL * float(want[2])
    assert torch.equal(got[2], again[2])


def test_smoke_update_on_the_card_matches_the_cpu(cuda):
    cfg = get_config(ARCH).smoke().replace(compute_dtype="float32")
    p_cpu = get_model(cfg).init(0, device="cpu")
    b_cpu = lm_batch(0, batch=8, seq_len=32, vocab=cfg.vocab_size,
                     device="cpu")
    b_cpu["encoder_input"] = torch.randn(
        8, cfg.encoder_frames, cfg.d_model,
        generator=torch.Generator().manual_seed(5))
    p_gpu = {k: v.to(cuda) for k, v in p_cpu.items()}
    b_gpu = {k: v.to(cuda) for k, v in b_cpu.items()}
    _, opt = build_step(cfg, "nghf", cg_frac=4, cg_iters=4, ng_iters=2,
                        cg_fused=True)
    new_c, _, mc = opt.step(p_cpu, opt.init(p_cpu), b_cpu,
                            cg_sub_batch(b_cpu, 4, 1))
    n0 = CG.cg_fused_update.launches
    new_g, _, mg = opt.step(p_gpu, opt.init(p_gpu), b_gpu,
                            cg_sub_batch(b_gpu, 4, 1))
    torch.cuda.synchronize()
    assert CG.cg_fused_update.launches == n0 + 6
    for key in ("cg_best_iter", "cg_accepted", "cg_iters_used"):
        assert float(mg[key]) == float(mc[key]), key
    torch.testing.assert_close(mg["cg_losses"].cpu(), mc["cg_losses"],
                               rtol=LOSS_RTOL, atol=0.0)
    num = sum(float(((new_g[k].cpu() - new_c[k]) ** 2).sum()) for k in p_cpu)
    den = sum(float(((new_c[k] - p_cpu[k]) ** 2).sum()) for k in p_cpu)
    assert (num / max(den, 1e-30)) ** 0.5 <= DELTA_REL_L2
