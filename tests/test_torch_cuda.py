"""The port's CUDA path on a card: kernels against their plain versions,
the service and the streaming session through the kernels, gradients
through the kernels, and a training update on the card.

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so they run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the repo's ``tests/conftest.py`` imports JAX.)

Tolerance against the plain versions: |d| <= 1e-4 + 1e-5 |ref| (f32,
sequential per-slot sums in the kernels against PyTorch's reductions).
The fused CG update: x and r bitwise in f32 (the same two roundings per
element; nvcc builds with -fmad=false) and within one bf16 rounding in
bf16; its rr within 1e-6 relative (a fixed tile tree against PyTorch's
sum), and bitwise between two launches.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

import numpy as np  # noqa: E402

from repro_torch.analysis.corpus import ADVERSARIAL_CASES  # noqa: E402
from repro_torch.kernels import cg_fused as CG  # noqa: E402
from repro_torch.kernels import lattice_fb as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.lattice_engine.cuda_backend import dag_level_tensors  # noqa: E402,E501
from repro_torch.lattice_engine.common import arc_scores  # noqa: E402
from repro_torch.losses.lattice import lattice_frontiers  # noqa: E402
from repro_torch.serving import packing  # noqa: E402
from repro_torch.serving.service import (RescoringService,  # noqa: E402
                                         synthetic_workload)
from repro_torch.serving.streaming import truncate_levels  # noqa: E402

KAPPA = 0.5
ATOL, RTOL = 1e-4, 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    for g, w in zip(got, want):
        assert torch.all((g - w).abs() <= ATOL + RTOL * w.abs())


@pytest.mark.parametrize("case", sorted(ADVERSARIAL_CASES))
def test_kernels_match_plain_versions(cuda, case):
    lat, T, Kc = ADVERSARIAL_CASES[case](0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    lp = torch.randn(lat.start_t.shape[0], T, Kc, generator=gen,
                     device=cuda).log_softmax(-1)
    fr = lattice_frontiers(lat)
    am = arc_scores(lat, lp, KAPPA) + lat.lm
    own, corr, start, ok, final = dag_level_tensors(lat, am, fr)
    counts = [k.launches for k in K.KERNELS]
    _close(K.dag_forward(own, corr, start, ok, final, fr.pidx),
           R.dag_forward_ref(own, corr, start, ok, final, fr.pidx))
    _close(K.dag_backward(own, corr, final, ok, fr.sidx),
           R.dag_backward_ref(own, corr, final, ok, fr.sidx))
    args = (lp, lat.start_t, lat.end_t, lat.label, lat.lm, lat.corr,
            lat.arc_mask, lat.is_start, lat.is_final, lat.level_arcs,
            fr.pidx)
    _close(K.dag_loss_only(*args, kappa=KAPPA),
           R.dag_loss_only_ref(*args, kappa=KAPPA))
    torch.cuda.synchronize()
    assert [k.launches for k in K.KERNELS[:3]] == [c + 1
                                                   for c in counts[:3]]


def test_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    own = torch.zeros(1, 2, 3, device=cuda)
    pidx = torch.zeros(1, 2, 3, 1, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        K.dag_forward(own, own, own, own, own, pidx)
    strided = torch.zeros(1, 3, 2, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        K.dag_backward(strided, own, own, own, pidx.to(torch.int32))


def test_service_and_streaming_through_the_kernels(cuda):
    reqs = synthetic_workload(0, 12)
    buckets = packing.derive_buckets([r.lattice for r in reqs], batch=4)
    K.reset_launch_counts()
    svc = RescoringService(buckets, kappa=KAPPA, device=cuda)
    reqs, metrics = svc.run(reqs)
    assert metrics["completed"] == 12 and K.dag_loss_only.launches > 0
    plain = RescoringService(buckets, kappa=KAPPA, device="cpu").rescore(
        [r.lattice for r in reqs], [r.log_probs for r in reqs])
    for r, p in zip(reqs, plain):
        for key in ("logZ", "c_avg"):
            assert abs(r.result[key] - p[key]) <= ATOL + RTOL * abs(p[key])
    d = reqs[2].lattice
    sess = svc.stream_session(d)
    cut = max(1, d["level_arcs"].shape[0] // 2)
    sess.rescore(truncate_levels(d, cut), reqs[2].log_probs)
    resumed = sess.rescore(d, reqs[2].log_probs)
    scratch = sess.rescore_from_scratch(d, reqs[2].log_probs)
    assert resumed.logZ == scratch.logZ and resumed.c_avg == scratch.c_avg
    # the session runs the forward recursion alone
    assert K.dag_forward.launches > 0 and K.dag_backward.launches == 0


def _sausage_case(dev, B, S, A, seed, ragged=True):
    gen = torch.Generator(device=dev).manual_seed(seed)
    scores = torch.randn(B, S, A, generator=gen, device=dev) * 3.0
    corr = (torch.rand(B, S, A, generator=gen, device=dev) > 0.6).float()
    mask = torch.ones(B, S, A, device=dev)
    if ragged:
        mask[0, S // 2:] = 0.0           # padded tail segments
        mask[1, 1 % S] = 0.0             # a fully masked segment inside
        mask[2 % B] = 0.0                # a fully masked utterance
        mask[:, :, A - 1] *= (torch.rand(B, S, device=dev,
                                         generator=gen) > 0.3).float()
    return scores, corr, mask


def _check_sausage_kernels(scores, corr, mask):
    """Both kernels against their plain versions, and bitwise on a repeat
    launch (the scan adds in a fixed shuffle order)."""
    counts = (K.sausage_forward.launches, K.sausage_backward.launches)
    for kern, plain in ((K.sausage_forward, R.sausage_forward_ref),
                        (K.sausage_backward, R.sausage_backward_ref)):
        got = kern(scores, corr, mask)
        _close(got, plain(scores, corr, mask))
        again = kern(scores, corr, mask)
        assert all(torch.equal(g, a) for g, a in zip(got, again))
    torch.cuda.synchronize()
    assert (K.sausage_forward.launches, K.sausage_backward.launches) == \
        (counts[0] + 2, counts[1] + 2)


@pytest.mark.parametrize("shape", [(32, 50, 3), (8, 50, 3), (4, 7, 40),
                                   (4, 33, 3), (4, 250, 3), (2, 1, 3)])
def test_sausage_kernels_match_plain_versions(cuda, shape):
    B, S, A = shape
    _check_sausage_kernels(*_sausage_case(cuda, B, S, A, seed=B + A))


def test_sausage_kernels_fractional_mask(cuda):
    """Masks of 0.3 and 0.7 on one row: the 0.7 arc is valid and weighs
    0.7, the 0.3 arc is masked; a row of 0.3 only is a masked segment."""
    scores, corr, mask = _sausage_case(cuda, 4, 9, 3, seed=9)
    mask[3, 2] = torch.tensor([1.0, 0.3, 0.7], device=cuda)
    mask[3, 4] = torch.tensor([0.3, 0.0, 0.3], device=cuda)
    mask[3, 6] = torch.tensor([0.0, 0.7, 0.0], device=cuda)
    _check_sausage_kernels(scores, corr, mask)


@pytest.mark.parametrize("batch", [8, 32])
def test_sausage_loss_only_matches_plain_version(cuda, batch):
    from repro_torch.data.synthetic import asr_batch
    lat = asr_batch(batch, batch=batch, num_frames=200, num_states=6000,
                    input_dim=8, device=cuda)["lattice"]
    gen = torch.Generator(device=cuda).manual_seed(batch)
    lp = torch.randn(batch, 200, 6000, generator=gen,
                     device=cuda).log_softmax(-1)
    args = (lp, lat.start_t, lat.end_t, lat.label, lat.lm, lat.corr,
            lat.arc_mask, lat.level_arcs)
    n = K.sausage_loss_only.launches
    _close(K.sausage_loss_only(*args, kappa=KAPPA),
           R.sausage_loss_only_ref(*args, kappa=KAPPA))
    torch.cuda.synchronize()
    assert K.sausage_loss_only.launches == n + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cg_fused_update_matches_plain_version(cuda, dtype):
    n = 3 * CG.TILE + 1234                 # a ragged last tile
    gen = torch.Generator(device=cuda).manual_seed(7)
    x, v, r, bv = (torch.randn(n, generator=gen, device=cuda).to(dtype)
                   for _ in range(4))
    alpha = torch.tensor(0.37, device=cuda)
    got = CG.cg_fused_update(alpha, x, v, r, bv)
    want = R.cg_fused_update_ref(alpha, x, v, r, bv)
    tol = 0 if dtype == torch.float32 else 1e-2
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == dtype
        assert torch.all((g.float() - w.float()).abs()
                         <= tol * w.float().abs())
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 * float(want[2])
    again = CG.cg_fused_update(alpha, x, v, r, bv)
    assert torch.equal(got[2], again[2])


def test_gradients_through_the_kernels(cuda):
    from repro_torch.data.synthetic import asr_batch
    from repro_torch.lattice_engine import lattice_stats
    lat = asr_batch(3, batch=4, num_frames=40, num_states=50, input_dim=8,
                    device=cuda)["lattice"]
    lp = torch.randn(4, 40, 50, device=cuda).log_softmax(-1)
    grads = {}
    for backend in ("cuda", "levelized"):
        for acc in ("full", "loss_only"):
            x = lp.clone().requires_grad_()
            st = lattice_stats(lat, x, KAPPA, backend=backend,
                               accumulators=acc)
            grads[backend, acc] = torch.autograd.grad(
                st.logZ.sum() + st.c_avg.sum(), x)[0]
    for acc in ("full", "loss_only"):
        _close([grads["cuda", acc]], [grads["levelized", acc]])


def test_one_nghf_update_on_the_card(cuda):
    from repro_torch.launch.train import train_sequence
    K.reset_launch_counts()
    CG.reset_launch_counts()
    _, log = train_sequence(arch="lstm-asr", smoke=True, steps=1, batch=8,
                            cg_batch=4, frames=24, cg_iters=3, ng_iters=2,
                            cg_fused=True, device=cuda, verbose=False)
    m = log[0]
    assert np.isfinite([v for v in m.values()]).all()
    assert K.sausage_forward.launches == K.sausage_backward.launches == 6
    assert CG.cg_fused_update.launches == 5
    assert K.sausage_loss_only.launches >= 1


def test_checkpoint_round_trip_keeps_the_card(cuda, tmp_path):
    from repro_torch.checkpoint.io import load_checkpoint, save_checkpoint
    gen = torch.Generator(device=cuda).manual_seed(5)
    tree = {"params": {"rec0.w": torch.randn(30, 40, generator=gen,
                                             device=cuda)},
            "opt_state": {"step": torch.tensor(3, dtype=torch.int32,
                                               device=cuda),
                          "h": torch.randn(17, generator=gen, device=cuda
                                           ).to(torch.bfloat16)}}
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, tree, step=3)
    got, step = load_checkpoint(ck, tree)
    assert step == 3
    for part in ("params", "opt_state"):
        for k, want in tree[part].items():
            g = got[part][k]
            assert g.device == want.device and g.dtype == want.dtype
            if g.dtype == torch.bfloat16:
                g, want = g.view(torch.int16), want.view(torch.int16)
            assert torch.equal(g, want)


def test_train_sequence_resumes_on_the_card(cuda, tmp_path):
    """Checkpoint after 2 updates, resume to 3 (the card's training is
    not bitwise reproducible, so the resumed update is not compared with
    an uninterrupted one)."""
    from repro_torch.launch.train import train_sequence
    ck = str(tmp_path / "ck")
    kw = dict(arch="lstm-asr", smoke=True, batch=8, cg_batch=4, frames=24,
              cg_iters=3, ng_iters=2, cg_fused=True, warm_start=True,
              adapt_lam=True, device=cuda, verbose=False, ckpt_dir=ck)
    train_sequence(steps=2, **kw)
    _, log = train_sequence(steps=3, resume=True, **kw)
    assert [m["step"] for m in log] == [2]
    assert np.isfinite([v for v in log[0].values()]).all()


def _dag_parts(dev, dicts):
    spec = packing.derive_buckets(dicts, batch=len(dicts), tiers=1)[0]
    lat, _ = packing.pack_requests(dicts, spec, device=dev)
    gen = torch.Generator(device=dev).manual_seed(len(dicts))
    lp = torch.randn(len(dicts), spec.num_frames, 11, generator=gen,
                     device=dev).log_softmax(-1)
    return lat, lp, lattice_frontiers(lat)


def _dag_inputs(dev, dicts):
    lat, lp, fr = _dag_parts(dev, dicts)
    am = arc_scores(lat, lp, KAPPA) + lat.lm
    return (*dag_level_tensors(lat, am, fr), fr.pidx)


# sausage cases: (frames, alternatives), and the (chain, state) branch
# each takes
SAUSAGE_BRANCH_CASES = {"wide_levels": (100, 40), "global_state": (1000, 40),
                        "global_warp_chain": (1000, 20)}
BRANCHES = {"wide_levels": ("block", "shared"),
            "global_state": ("block", "global"),
            "global_warp_chain": ("warp", "global"),
            "p1": ("warp", "shared")}


def _dag_branch_case(dev, case):
    """dag_forward inputs for each branch of its compacted design."""
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)
    rng = np.random.default_rng(3)
    if case in SAUSAGE_BRANCH_CASES:
        frames, n_alt = SAUSAGE_BRANCH_CASES[case]
        return _dag_inputs(dev, [make_sausage_lattice(
            rng, num_frames=frames - 8 * b, num_states=11, n_alt=n_alt)
            for b in range(2)])
    own, corr, start, ok, final, pidx = _dag_inputs(dev, [
        make_random_dag_lattice(rng, num_frames=200, num_states=11)
        for _ in range(3)])
    if case == "no_valid_slot":
        ok = ok.clone()
        ok[1] = 0.0
    elif case == "p1":
        pidx = pidx[..., :1].contiguous()
    elif case == "cross_level_preds":
        B, L, W, P = pidx.shape
        gen = torch.Generator(device=dev).manual_seed(4)
        pidx = torch.randint(0, L * W + 1, (B, L, W, P), generator=gen,
                             device=dev, dtype=torch.int32)
    return own, corr, start, ok, final, pidx


@pytest.mark.parametrize("case", ["wide_levels", "global_state",
                                  "global_warp_chain", "no_valid_slot",
                                  "p1", "cross_level_preds"])
def test_dag_forward_branches_match_plain_version(cuda, case):
    """Each branch of the compacted design: levels wider than a warp (the
    block-barrier chain) with the state in shared memory, and too large
    for it (10,000 valid slots at P = 40); the warp chain on a global
    state (5,000 slots at P = 20) and on a shared one; an utterance with
    no valid slot, P = 1, and predecessor positions on the slot's own and
    later levels and the dump slot; bitwise on a repeat."""
    fwd = _dag_branch_case(cuda, case)
    _, _, start, ok, _, pidx = fwd
    if case in BRANCHES:
        assert set(K.dag_branches("dag_forward", start, ok,
                                  pidx.shape[-1])) == {BRANCHES[case]}
    got = K.dag_forward(*fwd)
    _close(got, R.dag_forward_ref(*fwd))
    again = K.dag_forward(*fwd)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _dag_branch_parts(dev, case):
    """(dag_backward inputs, dag_loss_only inputs) for each branch of the
    compacted design, the cases of ``_dag_branch_case``."""
    from repro_torch.losses.lattice import (make_random_dag_lattice,
                                            make_sausage_lattice)
    rng = np.random.default_rng(3)
    if case in SAUSAGE_BRANCH_CASES:
        frames, n_alt = SAUSAGE_BRANCH_CASES[case]
        dicts = [make_sausage_lattice(rng, num_frames=frames - 8 * b,
                                      num_states=11, n_alt=n_alt)
                 for b in range(2)]
    else:
        dicts = [make_random_dag_lattice(rng, num_frames=200, num_states=11)
                 for _ in range(3)]
    lat, lp, fr = _dag_parts(dev, dicts)
    pidx, sidx, mask = fr.pidx, fr.sidx, lat.arc_mask
    if case == "no_valid_slot":
        mask = mask.clone()
        mask[1] = False
    elif case == "p1":
        pidx, sidx = pidx[..., :1].contiguous(), sidx[..., :1].contiguous()
    elif case == "cross_level_preds":
        B, L, W, P = pidx.shape
        gen = torch.Generator(device=dev).manual_seed(4)
        pidx, sidx = (torch.randint(0, L * W + 1, t.shape, generator=gen,
                                    device=dev, dtype=torch.int32)
                      for t in (pidx, sidx))
    lat = lat._replace(arc_mask=mask)
    fr = lattice_frontiers(lat)
    own, corr, _, ok, final = dag_level_tensors(
        lat, arc_scores(lat, lp, KAPPA) + lat.lm, fr)
    lo = (lp, lat.start_t, lat.end_t, lat.label, lat.lm, lat.corr,
          lat.arc_mask, lat.is_start, lat.is_final, lat.level_arcs, pidx)
    return (own, corr, final, ok, sidx), lo, fr


@pytest.mark.parametrize("case", ["wide_levels", "global_state",
                                  "global_warp_chain", "no_valid_slot",
                                  "p1", "cross_level_preds"])
def test_dag_backward_and_loss_only_branches_match_plain_version(cuda,
                                                                 case):
    """``dag_backward`` and ``dag_loss_only`` on the branch cases of
    ``dag_forward``: each takes the same (chain, state) branch there,
    matches its plain version (the loss-only within 1e-3 + 1e-5 |ref|:
    span sums against the centred cumsum, scores up to |s| ~ 4e3 at
    T = 1000), and is bitwise on a repeat; the cross-level case points
    rows into the slot's own, earlier and later levels."""
    bwd, lo, fr = _dag_branch_parts(cuda, case)
    if case in BRANCHES:
        assert set(K.dag_branches("dag_backward", fr.final, fr.ok,
                                  bwd[4].shape[-1])) == {BRANCHES[case]}
        assert set(K.dag_branches("dag_loss_only", fr.start, fr.ok,
                                  lo[-1].shape[-1])) == {BRANCHES[case]}
    got = K.dag_backward(*bwd)
    _close(got, R.dag_backward_ref(*bwd))
    again = K.dag_backward(*bwd)
    got_lo = K.dag_loss_only(*lo, kappa=KAPPA)
    want_lo = R.dag_loss_only_ref(*lo, kappa=KAPPA)
    again_lo = K.dag_loss_only(*lo, kappa=KAPPA)
    torch.cuda.synchronize()
    for g, w in zip(got_lo, want_lo):
        assert torch.all((g - w).abs() <= 1e-3 + 1e-5 * w.abs())
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got_lo, again_lo))


def _span_inputs(dev, B, T, S, W, max_span, Kc=6000, seed=0):
    """sausage_loss_only inputs with zero-length spans, spans ending at
    frame T, label K-1, -1 slots, an empty utterance and masked arcs with
    labels outside [0, K) (clamped for the plain version, whose gathers
    would fault on them; a masked arc never reaches the recursion)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = S * W
    start = torch.randint(0, T + 1, (B, A), generator=gen, device=dev,
                          dtype=torch.int32)
    span = (torch.rand(B, A, generator=gen, device=dev) ** 2
            * (max_span + 1)).to(torch.int32)
    end = torch.minimum(start + span, torch.full_like(start, T))
    end[:, 1::7] = start[:, 1::7]
    end[:, 2::7] = T
    if max_span >= T:
        start[:, 3::11], end[:, 3::11] = 0, T
    label = torch.randint(0, Kc, (B, A), generator=gen, device=dev,
                          dtype=torch.int32)
    label[:, ::5] = Kc - 1
    mask = torch.rand(B, A, generator=gen, device=dev) > 0.15
    mask[B - 1] = False
    bad = ~mask & (torch.rand(B, A, generator=gen, device=dev) > 0.5)
    label_kernel = torch.where(bad, label + Kc, label)
    lm = torch.randn(B, A, generator=gen, device=dev)
    corr = (torch.rand(B, A, generator=gen, device=dev) > 0.6).float()
    la = torch.stack([torch.randperm(A, generator=gen, device=dev)
                      for _ in range(B)]).to(torch.int32).reshape(B, S, W)
    la[:, ::3, W - 1] = -1
    lp = torch.randn(B, T, Kc, generator=gen, device=dev).log_softmax(-1)
    return ((lp, start, end, label_kernel, lm, corr, mask, la),
            (lp, start, end, label, lm, corr, mask, la))


@pytest.mark.parametrize("shape", [(8, 200, 50, 3, 12), (3, 1, 4, 3, 1),
                                   (3, 1000, 6, 5, 1000)])
def test_sausage_loss_only_adversarial_spans(cuda, shape):
    """The kernel's direct span sums against the plain version's centred
    cumsum: zero-length spans, arcs ending at T, label K-1, masked arcs
    with out-of-range labels, T = 1, and T = 1000 with spans up to T (the
    warp-summed long spans); bitwise on a repeat.  Tolerance: |d| <= 1e-3
    + 1e-5 |ref| (chip_smoke.py's; scores reach |s| ~ 4e3 at T = 1000)."""
    B, T, S, W, max_span = shape
    args, ref_args = _span_inputs(cuda, B, T, S, W, max_span)
    got = K.sausage_loss_only(*args, kappa=KAPPA)
    want = R.sausage_loss_only_ref(*ref_args, kappa=KAPPA)
    again = K.sausage_loss_only(*args, kappa=KAPPA)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.all((g - w).abs() <= 1e-3 + 1e-5 * w.abs())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("kernel", ["sausage_forward", "sausage_backward",
                                    "dag_forward", "dag_backward"])
def test_bf16_inputs_give_f32_outputs(cuda, kernel):
    """The card routes take bf16 scores as the CPU routes and the JAX
    functions do: cast to f32 on entry, f32 out, the same bits as for the
    inputs cast to f32 by the caller."""
    if kernel.startswith("sausage"):
        args = _sausage_case(cuda, 4, 9, 3, seed=4)
    else:
        lat, T, Kc = ADVERSARIAL_CASES["max_fanin"](0, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(0)
        lp = torch.randn(1, T, Kc, generator=gen, device=cuda).log_softmax(-1)
        fr = lattice_frontiers(lat)
        own, corr, start, ok, final = dag_level_tensors(
            lat, arc_scores(lat, lp, KAPPA) + lat.lm, fr)
        args = ((own, corr, start, ok, final, fr.pidx)
                if kernel == "dag_forward"
                else (own, corr, final, ok, fr.sidx))
    fn = getattr(K, kernel)
    low = [a.to(torch.bfloat16) if a.is_floating_point() else a
           for a in args]
    got = fn(*low)
    want = fn(*[a.float() if a.is_floating_point() else a for a in low])
    torch.cuda.synchronize()
    assert all(g.dtype == torch.float32 for g in got)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kernel_sanitizer_on_the_card(cuda):
    """The port's kernel sanitizer on the card: KS001-KS005 clean over the
    corpus and the vector kernels, every launcher of the seven libraries
    run, each capture's records equal to its ``build.launch`` calls, and
    both seeded mutants flagged."""
    from repro_torch.analysis import rules_kernel, sanitize_kernels
    report, failures = sanitize_kernels.run_sanitize(cuda)
    assert failures == []
    assert set(report["launches"]) == set(rules_kernel.STEM_OF)
    assert report["records"] == report["build_launches"] > 0
    assert sanitize_kernels.self_test(cuda) == []
