"""The dense archs on a card: the fused CG update at the size NGHF trains
qwen2.5-3b at on one card (full width, 8 of its 36 layers), and the
dense decode's cache writes on CUDA tensors against the same decode on
the CPU.

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so they run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_dense.py

Tolerances: ``cg_fused_update`` against its plain version, x and r
bitwise, ⟨r, r⟩ within 1e-6 relative, a repeat launch bitwise (as
``test_torch_cuda_lm_train.py``).  The decode at f32 compute (TF32 off)
within relative max 1e-5 of the CPU's logits and caches, the bound of
the CPU parity tests against the reference.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import cg_fused as CG  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

pytestmark = pytest.mark.cuda

ARCH = "qwen2.5-3b"
TRAIN_LAYERS = 8
N = 927_782_912
RR_RTOL = 1e-6
F32_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return resolve_device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cg_fused_update_at_the_dense_training_size(cuda, dtype):
    cfg = get_config(ARCH).replace(num_layers=TRAIN_LAYERS)
    assert get_model(cfg).param_count() == N
    gen = torch.Generator(device=cuda).manual_seed(11)
    x, v, r, bv = (torch.randn(N, generator=gen, device=cuda).to(dtype)
                   for _ in range(4))
    alpha = torch.tensor(0.29, device=cuda)
    n0 = CG.cg_fused_update.launches
    got = CG.cg_fused_update(alpha, x, v, r, bv)
    again = CG.cg_fused_update(alpha, x, v, r, bv)
    torch.cuda.synchronize()
    assert CG.cg_fused_update.launches == n0 + 2
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    del again
    want = R.cg_fused_update_ref(alpha, x, v, r, bv)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == dtype and torch.equal(g, w)
    assert abs(float(got[2]) - float(want[2])) <= RR_RTOL * float(want[2])


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("long_mode,cache_len,steps",
                         [(True, 128, 80), (False, 16, 20)],
                         ids=["ring", "clamped"])
def test_dense_decode_writes_its_cache_on_the_card(cuda, long_mode,
                                                   cache_len, steps):
    """qwen2.5-3b's smoke model at f32 compute: with ``long_mode`` the
    64-slot ring wraps after 64 steps, each step writing slot ``pos %
    64``; without it the last of 16 slots is overwritten past
    ``cache_len``.  Logits and caches as the CPU's."""
    cfg = get_config(ARCH).smoke().replace(compute_dtype="float32")
    model = get_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = {k: v.to(cuda) for k, v in p_cpu.items()}
    step = build_serve_step(cfg, long_mode=long_mode)
    c_cpu = model.init_cache(2, cache_len, long_mode=long_mode,
                             device="cpu")
    c_gpu = model.init_cache(2, cache_len, long_mode=long_mode, device=cuda)
    slots = c_gpu["periods.slot0.k"].shape[2]
    assert slots == (64 if long_mode else cache_len)
    toks = torch.randint(0, cfg.vocab_size, (2, steps),
                         generator=torch.Generator().manual_seed(3))
    for t in range(steps):
        before = c_gpu["periods.slot0.k"].clone()
        lc, c_cpu = step(p_cpu, c_cpu, toks[:, t:t + 1], t)
        lg, c_gpu = step(p_gpu, c_gpu, toks[:, t:t + 1].to(cuda), t)
        changed = (c_gpu["periods.slot0.k"] != before).any(
            dim=(0, 1, 3, 4)).nonzero().flatten().tolist()
        slot = t % slots if long_mode else min(t, slots - 1)
        assert changed == [slot], (t, changed)
        assert _rel(lg, lc) < F32_TOL, t
    for k in c_cpu:
        assert _rel(c_gpu[k], c_cpu[k]) < F32_TOL, k
