"""Port parity: the sausage kernels' plain versions and topology check.

The port's ``kernels.ref.sausage_forward_ref`` / ``sausage_backward_ref``
/ ``sausage_loss_only_ref`` — what the CUDA wrappers run on CPU tensors
and what ``chip_smoke.py`` holds the kernels against on the card —
against the JAX package's pure-jnp refs AND its interpret-mode Pallas
kernels (``repro.kernels.lattice_fb``), on the same numpy inputs:
ragged ``max_arcs`` padding, a fully masked segment, a fully masked
utterance, and A = 40 > 32 alternatives (more than one warp's lanes).
``lattice_is_sausage`` against the JAX one on sausages, random DAGs and
padded buckets; ``sausage_arc_scores_vjp`` against autograd of the score
map it transposes.

Tolerance: rtol 1e-5, atol 1e-4 — f32 on both sides, scores up to |s| ~
60 here (one ulp ~ 4e-6), logsumexp/softmax rows and the cumsum grid
summed in different orders by XLA and PyTorch.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import lattice_fb as JK  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.lattice_engine.common import lattice_is_sausage as jax_is_sausage  # noqa: E402,E501
from repro.losses import lattice as JL  # noqa: E402
from repro.serving import packing as jpacking  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import lattice_fb as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.lattice_engine import lattice_is_sausage  # noqa: E402

RTOL, ATOL = 1e-5, 1e-4
KAPPA = 0.5


def _tile_case(B, S, A, seed):
    """scores/corr/mask (B, S, A) with padded tail segments, a fully
    masked inner segment, a fully masked utterance and ragged arcs."""
    rng = np.random.default_rng(seed)
    scores = (rng.normal(0, 3, (B, S, A))).astype(np.float32)
    corr = (rng.random((B, S, A)) > 0.6).astype(np.float32)
    mask = np.ones((B, S, A), np.float32)
    mask[0, S // 2:] = 0.0
    mask[1, 1] = 0.0
    mask[2] = 0.0
    mask[:, :, A - 1] *= rng.random((B, S)) > 0.3
    scores = np.where(mask > 0, scores, -1e30).astype(np.float32)
    return scores, corr, mask


CASES = {"a3": (4, 9, 3), "a40": (3, 5, 40)}


@pytest.fixture(scope="module", params=sorted(CASES))
def tiles(request):
    scores, corr, mask = _tile_case(*CASES[request.param], seed=1)
    j = tuple(jnp.asarray(x) for x in (scores, corr, mask))
    jax_out = {
        "ref_fwd": JR.sausage_forward_ref(*j),
        "ref_bwd": JR.sausage_backward_ref(*j),
        "kern_fwd": JK.sausage_forward(*j, interpret=True),
        "kern_bwd": JK.sausage_backward(*j, interpret=True),
    }
    jax_out = {k: [np.asarray(x) for x in v] for k, v in jax_out.items()}
    t = tuple(torch.from_numpy(x) for x in (scores, corr, mask))
    return t, jax_out


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("jax_side", ["ref", "kern"])
def test_sausage_forward_plain_matches_jax(tiles, jax_side):
    t, want = tiles
    got = R.sausage_forward_ref(*t)
    _close(got, want[f"{jax_side}_fwd"])
    # the wrapper runs the plain version for CPU tensors
    for g, w in zip(K.sausage_forward(*t), got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("jax_side", ["ref", "kern"])
def test_sausage_backward_plain_matches_jax(tiles, jax_side):
    t, want = tiles
    got = R.sausage_backward_ref(*t)
    _close(got, want[f"{jax_side}_bwd"])
    for g, w in zip(K.sausage_backward(*t), got):
        assert torch.equal(g, w)


def test_fully_masked_utterance_keeps_the_zero_carry(tiles):
    t, _ = tiles
    _, _, logz, cavg = R.sausage_forward_ref(*t)
    assert float(logz[2]) == 0.0 and float(cavg[2]) == 0.0


def _sausage_bucket(seed, n_alt=3):
    """Ragged sausages (different lengths, max_arcs padding) packed into
    one bucket (level padding too)."""
    rng = np.random.default_rng(seed)
    dicts = [JL.make_sausage_lattice(rng, num_frames=t, num_states=7,
                                     n_alt=n_alt, max_arcs=m)
             for t, m in ((16, 16 * n_alt // 4 + 5), (12, None),
                          (16, None), (8, 30))]
    spec = jpacking.derive_buckets(dicts, batch=len(dicts), tiers=1)[0]
    lat, _ = jpacking.pack_requests(dicts, spec)
    lp = rng.normal(0, 1, (spec.batch, spec.num_frames, 7)).astype(
        np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    return lat, lp


@pytest.mark.parametrize("n_alt", [3, 40])
def test_sausage_loss_only_plain_matches_jax(n_alt):
    lat, lp = _sausage_bucket(2, n_alt)
    args = (jnp.asarray(lp), lat.start_t, lat.end_t, lat.label, lat.lm,
            lat.corr, lat.arc_mask, lat.level_arcs)
    want_ref = JR.sausage_loss_only_ref(*args, kappa=KAPPA)
    want_kern = JK.sausage_loss_only(*args, kappa=KAPPA, interpret=True)
    tlat = convert.lattice_from_numpy(
        {f: np.asarray(getattr(lat, f)) for f in lat._fields}, device="cpu")
    targs = (torch.from_numpy(lp), tlat.start_t, tlat.end_t, tlat.label,
             tlat.lm, tlat.corr, tlat.arc_mask, tlat.level_arcs)
    got = R.sausage_loss_only_ref(*targs, kappa=KAPPA)
    for want in (want_ref, want_kern):
        _close(got, [np.asarray(w) for w in want])
    for g, w in zip(K.sausage_loss_only(*targs, kappa=KAPPA), got):
        assert torch.equal(g, w)


def _dag_bucket(seed):
    rng = np.random.default_rng(seed)
    dicts = [JL.make_random_dag_lattice(rng, num_frames=12, num_states=5)
             for _ in range(3)]
    spec = jpacking.derive_buckets(dicts, batch=3, tiers=1)[0]
    return jpacking.pack_requests(dicts, spec)[0]


def _mixed_bucket(seed):
    rng = np.random.default_rng(seed)
    dicts = [JL.make_sausage_lattice(rng, num_frames=8, num_states=5),
             JL.make_random_dag_lattice(rng, num_frames=8, num_states=5)]
    spec = jpacking.derive_buckets(dicts, batch=2, tiers=1)[0]
    return jpacking.pack_requests(dicts, spec)[0]


def _masked_bucket(seed):
    lat, _ = _sausage_bucket(seed)
    mask = np.asarray(lat.arc_mask).copy()
    mask[1] = False                       # a fully padded row
    la = np.asarray(lat.level_arcs).copy()
    la[1] = -1
    return lat._replace(arc_mask=jnp.asarray(mask),
                        level_arcs=jnp.asarray(la))


TOPOLOGY_CASES = {
    "sausage_bucket": lambda: _sausage_bucket(0)[0],
    "sausage_batch": lambda: JL.make_lattice_batch(3, batch=4, num_frames=16,
                                                   num_states=6),
    "dag_bucket": lambda: _dag_bucket(1),
    "mixed_bucket": lambda: _mixed_bucket(4),
    "padded_row": lambda: _masked_bucket(5),
}


@pytest.mark.parametrize("case", sorted(TOPOLOGY_CASES))
def test_lattice_is_sausage_matches_jax(case):
    lat = TOPOLOGY_CASES[case]()
    tlat = convert.lattice_from_numpy(
        {f: np.asarray(getattr(lat, f)) for f in lat._fields}, device="cpu")
    want = jax_is_sausage(lat)
    assert lattice_is_sausage(tlat) is want
    assert lattice_is_sausage(tlat) is want      # memoized, same answer
    assert want is (case.startswith("sausage"))


def test_arc_scores_vjp_is_the_transpose():
    lat, lp = _sausage_bucket(3)
    tlat = convert.lattice_from_numpy(
        {f: np.asarray(getattr(lat, f)) for f in lat._fields}, device="cpu")
    x = torch.from_numpy(lp).requires_grad_()
    scores = R.sausage_arc_scores_ref(x, tlat.start_t, tlat.end_t,
                                      tlat.label, KAPPA)
    ds = torch.from_numpy(np.random.default_rng(0).normal(
        size=scores.shape).astype(np.float32))
    want = torch.autograd.grad(scores, x, ds)[0]
    B, T, Kc = lp.shape
    got = R.sausage_arc_scores_vjp(ds, tlat.start_t, tlat.end_t, tlat.label,
                                   T, Kc, KAPPA)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
