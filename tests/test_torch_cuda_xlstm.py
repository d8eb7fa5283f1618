"""The xLSTM arch on a card: the chunkwise mLSTM at xlstm-125m's full head
width against its step recurrence, an sLSTM block and the smoke model's
forward, decode and one NGHF update (fused CG) against the same calls on
the CPU.

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so they run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_xlstm.py

Tolerances, all at f32 compute (TF32 off): the chunkwise form against
``_mlstm_step`` on the card within relative L2 1e-5 (outputs) and 1e-4
(gradients); the card against the CPU within relative L2 1e-5 (the same
f32 arithmetic, sums in another order); one NGHF update without
candidate selection, Δθ within relative L2 1e-4 of the CPU's.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import build_serve_step  # noqa: E402
from repro_torch.launch.steps import build_step, cg_sub_batch  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

ARCH = "xlstm-125m"
F32_L2 = 1e-5
GRAD_L2 = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return resolve_device("cuda")


def _l2(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_chunkwise_mlstm_at_full_head_width_is_the_recurrence(cuda):
    """B 2, T 300 (chunks of 64 and a ragged last one), H 4, hd 384, f32:
    outputs and the gradients of (h · c) against the step recurrence."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    Bn, T, H, hd = 2, 300, 4, 384
    q, k, v = (torch.randn(Bn, T, H, hd, generator=gen, device=cuda)
               .requires_grad_(True) for _ in range(3))
    li = (2 * torch.randn(Bn, T, H, generator=gen, device=cuda)) \
        .requires_grad_(True)
    lf = torch.nn.functional.logsigmoid(
        3 + 2 * torch.randn(Bn, T, H, generator=gen, device=cuda)) \
        .detach().requires_grad_(True)
    leaves = (q, k, v, li, lf)

    def ins():
        return (q, k / hd ** 0.5, v, li, lf)

    carry = (torch.zeros(Bn, H, hd, hd, device=cuda),
             torch.zeros(Bn, H, hd, device=cuda),
             torch.full((Bn, H), -1e30, device=cuda))
    hs, step_ins = [], ins()
    for t in range(T):
        carry, h = B._mlstm_step(carry, tuple(a[:, t] for a in step_ins))
        hs.append(h)
    want = torch.stack(hs, 1)
    c = torch.randn(want.shape, generator=gen, device=cuda)
    want_g = torch.autograd.grad((want * c).sum(), leaves)
    got = B.mlstm_chunkwise(*ins())
    got_g = torch.autograd.grad((got * c).sum(), leaves)
    assert _l2(got, want) < F32_L2
    for g, w in zip(got_g, want_g):
        assert _l2(g, w) < GRAD_L2


@pytest.mark.parametrize("T", [64, 300])
def test_graphed_scan_gives_the_plain_loops_bits(cuda, T):
    """``blocks._scan`` at xlstm-125m's sLSTM width (H 4, B 2, hd 192):
    the CUDA-graph chunks (64 steps; T = 300 leaves a plain tail of 44)
    against the plain loop on the card, forward and reverse (the
    backward's step on the forward's coefficients), bitwise."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    H, Bn, hd = 4, 2, 192
    pre_x = 2 * torch.randn(T, H, Bn, 4 * hd, generator=gen, device=cuda)
    R = torch.randn(H, hd, 4 * hd, generator=gen, device=cuda) / hd ** 0.5
    zero = B._slstm_zero(pre_x)
    graphed = B._scan(B._slstm_record_step, (R,), zero, (pre_x,), 5)
    plain = B._scan(B._slstm_record_step, (R,), zero, (pre_x,), 5,
                    chunk=T + 1)
    for got, want in zip(graphed[1] + graphed[0], plain[1] + plain[0]):
        assert torch.equal(got, want)
    k = B._SLSTMScan._coefficients(*plain[1])
    xs = (torch.randn(T, H, Bn, hd, generator=gen, device=cuda),) \
        + tuple(k.values())
    state = (torch.zeros(H, Bn, hd, device=cuda),) * 4 \
        + (torch.zeros(H, Bn, 4 * hd, device=cuda),)
    args = (B._slstm_reverse_step, (R.transpose(1, 2),), state, xs, 1)
    got = B._scan(*args, reverse=True)[1][0]
    want = B._scan(*args, reverse=True, chunk=T + 1)[1][0]
    assert torch.equal(got, want)


def _smoke(cuda):
    cfg = get_config(ARCH).smoke().replace(compute_dtype="float32")
    params = TT.init_params(cfg, 0, device="cpu")
    return cfg, params, {k: v.to(cuda) for k, v in params.items()}


def test_smoke_forward_and_decode_match_the_cpu(cuda):
    cfg, p_cpu, p_gpu = _smoke(cuda)
    model = get_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 100),
                         generator=torch.Generator().manual_seed(1))
    want, _ = model.forward(p_cpu, {"tokens": toks})
    got, _ = model.forward(p_gpu, {"tokens": toks.to(cuda)})
    assert got.device.type == "cuda" and _l2(got, want) < F32_L2
    step = build_serve_step(cfg)
    caches = [model.init_cache(2, 16, device=d) for d in ("cpu", cuda)]
    for t in range(12):
        lc, _ = step(p_cpu, caches[0], toks[:, t:t + 1], t)
        lg, _ = step(p_gpu, caches[1], toks[:, t:t + 1].to(cuda), t)
        assert _l2(lg, lc) < F32_L2, t
    for key, val in caches[1].items():
        assert _l2(val, caches[0][key]) < F32_L2, key


def test_smoke_nghf_update_matches_the_cpu(cuda):
    """One NGHF update through ``build_step`` (4 CG, 2 NG iterations, fused
    CG: ``cg_fused_update`` on the card, its plain version on the CPU),
    without candidate selection, from the same parameters and batch."""
    cfg, p_cpu, p_gpu = _smoke(cuda)
    out = []
    for dev, params in (("cpu", p_cpu), (cuda, p_gpu)):
        _, opt = build_step(cfg, "nghf", cg_frac=4, cg_iters=4, ng_iters=2,
                            cg_fused=True, eval_candidates=False)
        b = lm_batch(0, batch=8, seq_len=32, vocab=cfg.vocab_size,
                     device=dev)
        b["labels"] = b["tokens"]
        new, _, m = opt.step(params, opt.init(params), b,
                             cg_sub_batch(b, 4, 1))
        out.append(({k: new[k] - params[k] for k in params}, m))
    (d_cpu, m_cpu), (d_gpu, m_gpu) = out
    assert int(m_gpu["cg_iters_used"]) == int(m_cpu["cg_iters_used"])
    num = sum(float(torch.sum((d_gpu[k].cpu() - d_cpu[k]) ** 2))
              for k in d_cpu)
    den = sum(float(torch.sum(d_cpu[k] ** 2)) for k in d_cpu)
    assert den > 0 and (num / den) ** 0.5 < GRAD_L2
