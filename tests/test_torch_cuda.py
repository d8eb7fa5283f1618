"""The port's CUDA path on a card: kernels against their plain versions,
the service and the streaming session through the kernels.

These tests need a CUDA card and skip without one (decided inside the
``cuda`` fixture, never at import).  They import no JAX, so they run on
the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the repo's ``tests/conftest.py`` imports JAX.)

Tolerance against the plain versions: |d| <= 1e-4 + 1e-5 |ref| (f32,
sequential per-slot sums in the kernels against PyTorch's reductions).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.corpus import ADVERSARIAL_CASES  # noqa: E402
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
    assert [k.launches for k in K.KERNELS] == [c + 1 for c in counts]


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
    assert K.dag_forward.launches > 0 and K.dag_backward.launches > 0
