"""Port parity: the plain versions of the three DAG kernels.

``repro_torch.kernels.ref.dag_forward_ref`` / ``dag_backward_ref`` /
``dag_loss_only_ref`` against the JAX package's Pallas kernels
``repro.kernels.lattice_fb.dag_*`` run as its own tests run them on the
CPU (interpret mode), on the same numpy inputs: random DAGs, sausages and
every adversarial corpus case, all padded into one bucket (rows of a
batch never exchange data, so one call per kernel covers every case).
The port's kernel wrappers take exactly these plain versions for CPU
tensors, checked bitwise too.

Tolerance: rtol = atol = 1e-5.  Both sides are f32; XLA and PyTorch sum
the cumsum grid and the masked softmax rows in different orders, and the
Pallas loss-only kernel scales the grid by kappa before the endpoint
difference where the plain version scales after it (a few ulp at the
|score| <= 50 of these shapes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import corpus as jcorpus  # noqa: E402
from repro.kernels import lattice_fb as JK  # noqa: E402
from repro.losses import lattice as JL  # noqa: E402
from repro_torch.kernels import lattice_fb as TK  # noqa: E402
from repro_torch.kernels import ref as TR  # noqa: E402

KAPPA = 0.5
K = 6
NEG = -1e30
RTOL = ATOL = 1e-5


def _dags(seed):
    rng = np.random.default_rng(seed)
    return JL.batch_lattices([JL.make_random_dag_lattice(
        rng, num_frames=12, num_states=K, max_arcs=70) for _ in range(3)]), \
        12, K


def _sausages(seed):
    rng = np.random.default_rng(seed)
    return JL.batch_lattices([
        JL.make_sausage_lattice(rng, num_frames=12, num_states=K, n_alt=3),
        JL.make_sausage_lattice(rng, num_frames=12, num_states=K, n_alt=2,
                                max_arcs=9)]), 12, K


CASES = {"dag": _dags, "sausage": _sausages, **jcorpus.ADVERSARIAL_CASES}


def _rows(lat):
    """The utterances of a batched JAX lattice as numpy lattice dicts."""
    fields = {f: np.asarray(getattr(lat, f)) for f in lat._fields}
    return [{f: v[b] for f, v in fields.items()}
            for b in range(fields["start_t"].shape[0])]


@pytest.fixture(scope="module")
def padded():
    """Every case's utterances padded into ONE bucket, so that one
    interpret-mode call per Pallas kernel covers all cases; the inputs of
    the three kernels as numpy, and each case's rows."""
    from repro.serving import packing
    rows, spans = [], {}
    for name in sorted(CASES):
        lat, _, _ = CASES[name](0)
        r = _rows(lat)
        spans[name] = slice(len(rows), len(rows) + len(r))
        rows += r
    spec = packing.derive_buckets(rows, batch=len(rows), tiers=1)[0]
    lat = JL.batch_lattices([packing.pad_to_bucket(d, spec) for d in rows])
    fr = jax.jit(JL.lattice_frontiers)(lat)
    rng = np.random.default_rng(2)
    la = np.asarray(lat.level_arcs)
    own = np.where(la >= 0, rng.normal(0, 2, la.shape), NEG).astype(
        np.float32)
    corr = np.where(la >= 0, rng.random(la.shape), 0.0).astype(np.float32)
    lp = rng.normal(0, 1, (len(rows), spec.num_frames, K)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    f32 = lambda x: np.asarray(x).astype(np.float32)  # noqa: E731
    inputs = dict(
        fwd=(own, corr, f32(fr.start), f32(fr.ok), f32(fr.final),
             np.array(fr.pidx)),
        bwd=(own, corr, f32(fr.final), f32(fr.ok), np.array(fr.sidx)),
        loss_only=(lp, *(np.array(getattr(lat, f)) for f in (
            "start_t", "end_t", "label", "lm", "corr", "arc_mask",
            "is_start", "is_final", "level_arcs")), np.array(fr.pidx)))
    return spans, inputs


# (JAX Pallas kernel, port plain version, port wrapper, keyword args)
KERNELS = {
    "fwd": (JK.dag_forward, TR.dag_forward_ref, TK.dag_forward, {}),
    "bwd": (JK.dag_backward, TR.dag_backward_ref, TK.dag_backward, {}),
    "loss_only": (JK.dag_loss_only, TR.dag_loss_only_ref, TK.dag_loss_only,
                  {"kappa": KAPPA}),
}


@pytest.fixture(scope="module")
def outputs(padded):
    """{kernel: (JAX outputs, port plain outputs, port inputs)}."""
    _, inputs = padded
    out = {}
    for kernel, (jax_fn, ref_fn, _, kw) in KERNELS.items():
        args = inputs[kernel]
        want = jax_fn(*(jnp.asarray(a) for a in args), **kw)
        targs = [torch.from_numpy(a) for a in args]
        out[kernel] = ([np.asarray(w) for w in want], ref_fn(*targs, **kw),
                       targs)
    return out


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_pallas_kernel(padded, outputs, name,
                                             kernel):
    spans, _ = padded
    want, got, targs = outputs[kernel]
    rows = spans[name]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g[rows].numpy(), w[rows], rtol=RTOL,
                                   atol=ATOL)
    # the wrapper's CPU path IS the plain version: bitwise, and no launch
    wrapper, kw = KERNELS[kernel][2], KERNELS[kernel][3]
    before = wrapper.launches
    for g, w in zip(wrapper(*targs, **kw), got):
        assert torch.equal(g, w)
    assert wrapper.launches == before


def test_masked_lse_row_all_masked_gives_neg_and_zero_weights():
    x = torch.tensor([[NEG, NEG, NEG], [0.5, NEG, -1.0]])
    lse, w = TR._masked_lse_row(x)
    assert lse[0].item() == np.float32(NEG)
    assert torch.equal(w[0], torch.zeros(3))
    np.testing.assert_allclose(lse[1].item(),
                               np.log(np.exp(0.5) + np.exp(-1.0)),
                               rtol=1e-6)
    assert w[1, 1].item() == 0.0


def test_wrappers_check_shapes():
    own = torch.zeros(1, 2, 3)
    with pytest.raises(ValueError, match="pidx"):
        TK.dag_forward(own, own, own, own, own,
                       torch.zeros(1, 2, 4, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="several devices"):
        TK._on_cuda("x", own, torch.zeros(1, device="meta"))
