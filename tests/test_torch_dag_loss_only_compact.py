"""The plan of the Hopper ``dag_loss_only`` kernel, emulated on the CPU.

``kernels/csrc/lattice_dag.cu::dag_loss_only_kernel`` is one launch from
the raw (B, T, K) log-probs.  Its prepass compacts the valid slots (a
slot is valid when its ``level_arcs`` id is in [0, A) and the arc's mask
is set; start and final are ANDed with that), as ``dag_forward``'s does
with ``ok``.  Each valid slot's score is then kappa times the direct sum
of ``lp[t, label]`` over its span plus lm (a span of more than 32 frames
summed by a warp, lane j over frames j, j+32, ..., then an xor
butterfly; frames clamped to [0, T], labels to [0, K), end < start gives
the negated sum), its predecessor rows are translated by the forward
rule (only valid slots on an earlier level keep their id), and
``dag_forward``'s chain and sequential fold over the final slots give
(logZ, c_avg); no cumsum grid and no alpha output.  The CUDA kernel runs
only on a card; this file repeats that plan in numpy float32 (the span
sums of ``test_torch_loss_only_spans``, the compaction, chain and fold
of ``test_torch_dag_compact``) and holds it to the port's plain version
``kernels.ref.dag_loss_only_ref`` (the reference's mean-centred cumsum)
and to the JAX package's ``dag_loss_only`` Pallas kernel in interpret
mode, on the five corpus cases, a random-DAG B=8 bucket, the service
bucket's shape at small K, a case whose predecessor rows point at random
into the slot's own, earlier and later levels and the dump slot, and a
case of adversarial spans (reversed, zero-length, up to T frames, label
K-1, a float mask, masked arcs with labels outside [0, K), which the two
references, whose gathers would fault, get clamped).

Tolerance: |d| <= 1e-3 + 1e-5 |ref|, ``chip_smoke.py``'s bound for the
kernel against the plain version: the direct span sum and the centred
cumsum difference round differently (as for ``sausage_loss_only``).
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import lattice_fb as JK  # noqa: E402
from repro_torch.analysis.corpus import ADVERSARIAL_CASES  # noqa: E402
from repro_torch.kernels import lattice_fb as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels.build import CSRC  # noqa: E402
from repro_torch.losses.lattice import (lattice_frontiers,  # noqa: E402
                                        make_random_dag_lattice)
from repro_torch.serving import packing  # noqa: E402
from test_torch_dag_compact import _lp, emulate as forward_emulate  # noqa: E402,E501
from test_torch_loss_only_spans import KAPPA, SHORT_SPAN, span_score  # noqa: E402,E501

NEG = np.float32(-1e30)
ATOL, RTOL = 1e-3, 1e-5
FIELDS = ("start_t", "end_t", "label", "lm", "corr", "arc_mask", "is_start",
          "is_final", "level_arcs")


def slot_tensors(lp, start, end, label, lm, corr, mask, is_start, is_final,
                 la):
    """The kernel's view of the arc layout, level-major: (own, corr,
    start, ok, final), own the span-sum score of each valid slot."""
    B, T, Kc = lp.shape
    A = start.shape[1]
    L, W = la.shape[1:]
    own = np.full((B, L * W), NEG, np.float32)
    co, st, ok, fn = (np.zeros((B, L * W), np.float32) for _ in range(4))
    for b in range(B):
        for s, a in enumerate(la[b].reshape(-1)):
            if not (0 <= a < A and mask[b, a] > 0.5):
                continue
            ok[b, s] = 1
            st[b, s] = is_start[b, a] > 0.5
            fn[b, s] = is_final[b, a] > 0.5
            co[b, s] = corr[b, a]
            col = lp[b, :, min(max(label[b, a], 0), Kc - 1)]
            own[b, s] = span_score(col, start[b, a], end[b, a], T, lm[b, a])
    return tuple(x.reshape(B, L, W) for x in (own, co, st, ok, fn))


def emulate(lp, start, end, label, lm, corr, mask, is_start, is_final, la,
            pidx):
    """The kernel on numpy inputs: (logZ (B,), c_avg (B,))."""
    own, co, st, ok, fn = slot_tensors(lp, start, end, label, lm, corr, mask,
                                       is_start, is_final, la)
    return forward_emulate(own, co, st, ok, fn, pidx)[2:4]


def _corpus_lat(name):
    return ADVERSARIAL_CASES[name](0, device="cpu")[0]


def _bucket_lat(seed, frames, Kc=7):
    """Eight random DAGs packed into one bucket: (lattice, spec, the
    generator, which goes on to draw the log-probs)."""
    rng = np.random.default_rng(seed)
    dicts = [make_random_dag_lattice(rng, num_frames=frames, num_states=Kc)
             for _ in range(8)]
    spec = packing.derive_buckets(dicts, batch=8, tiers=1)[0]
    return packing.pack_requests(dicts, spec, device="cpu")[0], spec, rng


def loss_only_args(lat, lp):
    fr = lattice_frontiers(lat)
    args = (lp.numpy(),) + tuple(getattr(lat, f).numpy() for f in FIELDS) \
        + (fr.pidx.numpy(),)
    return args, args


def _corpus(name):
    lat, T, Kc = ADVERSARIAL_CASES[name](0, device="cpu")
    return loss_only_args(lat, _lp(np.random.default_rng(1),
                                   lat.start_t.shape[0], T, Kc))


def _bucket(seed, frames, Kc=7):
    lat, spec, rng = _bucket_lat(seed, frames, Kc)
    return loss_only_args(lat, _lp(rng, 8, spec.num_frames, Kc))


def _cross_level():
    """dag_b8's inputs with predecessor positions drawn over [0, L*W]:
    the slot's own level, earlier and later levels and the dump slot."""
    args, _ = _bucket(3, 60)
    pidx = args[-1]
    B, L, W, P = pidx.shape
    wild = np.random.default_rng(8).integers(0, L * W + 1, pidx.shape)
    args = args[:-1] + (wild.astype(np.int32),)
    return args, args


def _spans():
    """dag_b8's lattices (T = 120, K = 40) with adversarial arcs: reversed
    spans (end < start), zero-length spans, spans of up to T frames (the
    warp-summed long spans), label K-1, a float mask of 0 / 0.7 / 1, and
    masked arcs with labels outside [0, K) for the kernel (in range for
    the references)."""
    Kc, T = 40, 120
    (lp, start, end, label, lm, corr, mask, st, fn, la, pidx), _ = \
        _bucket(5, T, Kc)
    rng = np.random.default_rng(9)
    B, A = start.shape
    start, end, label = start.copy(), end.copy(), label.copy()
    start[:, 1::7], end[:, 1::7] = end[:, 1::7].copy(), \
        start[:, 1::7].copy()                            # reversed
    end[:, 2::7] = start[:, 2::7]                        # zero-length
    start[:, 3::7], end[:, 3::7] = 0, T                  # the whole utterance
    long = rng.integers(33, T + 1, (B, A))
    start[:, 4::7] = 0
    end[:, 4::7] = long[:, 4::7]
    label[:, ::5] = Kc - 1
    fmask = np.where(rng.random((B, A)) > 0.15,
                     np.where(rng.random((B, A)) > 0.5, 1.0, 0.7),
                     0.0).astype(np.float32)
    bad = (fmask == 0) & (rng.random((B, A)) > 0.5)
    label_kernel = np.where(bad, np.where(rng.random((B, A)) > 0.5,
                                          label + Kc, -1 - label),
                            label).astype(np.int32)
    kern = (lp, start, end, label_kernel, lm, corr, fmask, st, fn, la, pidx)
    return kern, kern[:3] + (label,) + kern[4:]


CASES = {**{f"corpus_{n}": (lambda n=n: _corpus(n))
            for n in sorted(ADVERSARIAL_CASES)},
         "dag_b8": lambda: _bucket(3, 60),
         # the service bucket's shape (8, ~250, 9): random DAGs of T = 1000
         "service_bucket": lambda: _bucket(11, 1000),
         "cross_level_preds": _cross_level,
         "adversarial_spans": _spans}


FRONTIER_FLAGS = {
    **{f"corpus_{n}": (lambda n=n: _frontier_flags(lambda: _corpus_lat(n)))
       for n in sorted(ADVERSARIAL_CASES)},
    "dag_b8": lambda: _frontier_flags(lambda: _bucket_lat(3, 60)[0]),
    "service_bucket": lambda: _frontier_flags(
        lambda: _bucket_lat(11, 1000)[0]),
    "cross_level_preds": lambda: _frontier_flags(
        lambda: _bucket_lat(3, 60)[0]),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    args, ref_args = CASES[request.param]()
    return request.param, args, ref_args, emulate(*args)


def _close(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert np.all(np.abs(g - w) <= ATOL + RTOL * np.abs(w)), (g, w)


def test_emulation_matches_plain_version(case):
    _, _, ref_args, emu = case
    targs = [torch.from_numpy(np.asarray(a)) for a in ref_args]
    want = R.dag_loss_only_ref(*targs, kappa=KAPPA)
    _close(emu, [w.numpy() for w in want])
    # the wrapper takes the plain version for CPU tensors, with no launch
    n = K.dag_loss_only.launches
    got = K.dag_loss_only(*targs, kappa=KAPPA)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.dag_loss_only.launches == n


def test_emulation_matches_jax_interpret_kernel(case):
    _, _, ref_args, emu = case
    want = JK.dag_loss_only(*(jnp.asarray(a) for a in ref_args),
                            kappa=KAPPA, interpret=True)
    _close(emu, want)


def test_the_cases_reach_every_edge(case):
    name, args, ref_args, _ = case
    lp, start, end, label, _, _, mask, _, _, la, pidx = args
    B, T, Kc = lp.shape
    L, W = la.shape[1:]
    if name == "service_bucket":
        assert B == 8 and W == 9 and 200 <= L <= 300
    if name == "adversarial_spans":
        valid = np.asarray(mask) > 0.5
        span = end - start
        assert (valid & (span < 0)).any() and (valid & (span == 0)).any()
        assert (valid & (span > SHORT_SPAN)).any()
        assert (valid & (span == T)).any() and (label == Kc - 1).any()
        assert ((np.asarray(mask) == np.float32(0.7)) & valid).any()
        bad = (label < 0) | (label >= Kc)
        assert bad.any() and not (valid & bad).any()
        np.testing.assert_array_equal(np.where(bad, 0, label),
                                      np.where(bad, 0, ref_args[3]))
    if name == "cross_level_preds":
        lvl = np.arange(L * W) // W
        rows = pidx.reshape(B, L * W, -1)
        inside = rows < L * W
        tgt = np.where(inside, rows, 0) // W
        for rel in (np.equal, np.less, np.greater):
            assert (inside & rel(tgt, lvl[None, :, None])).any()


def test_valid_slots_follow_the_plain_versions_rule(case):
    """The kernel's slot rule (arc id in [0, A), mask set; start / final
    ANDed with it) gives the flags the plain version gathers from the arc
    layout, and on bool masks the frontiers' ok / start / final, which are
    what ``dag_forward`` gets: so ``dag_branches("dag_loss_only",
    fr.start, fr.ok, P)`` is the branch the kernel takes."""
    name, args, ref_args, _ = case
    _, st, ok, fn = slot_tensors(*args[:10])[1:]
    t = [torch.from_numpy(np.asarray(a)) for a in ref_args]
    la = t[9]
    ok_ref = R.gather_sausage_ref(t[6].float(), la, 0.0)
    want = [ok_ref, R.gather_sausage_ref(t[7].float(), la, 0.0) * ok_ref,
            R.gather_sausage_ref(t[8].float(), la, 0.0) * ok_ref]
    for got, w in zip((ok, st, fn), want):
        np.testing.assert_array_equal(got > 0.5, w.numpy() > 0.5)
    if t[6].dtype == torch.bool:
        fr = FRONTIER_FLAGS[name]()
        for got, w in zip((ok, st, fn), fr):
            np.testing.assert_array_equal(got > 0.5, w.numpy())


def _frontier_flags(make):
    lat = make()
    fr = lattice_frontiers(lat)
    return fr.ok, fr.start, fr.final


def test_state_bytes_and_launch_plan():
    """The loss-only kernel holds ``dag_forward``'s compact state (the
    same ``compact_bytes`` in the source), so ``dag_forward_plan`` sizes
    its launch; its long spans are those over kShortSpan frames."""
    src = (CSRC / "lattice_dag.cu").read_text()
    assert f"kShortSpan = {SHORT_SPAN};" in src
    assert re.search(r"loss_only_compact\(.*?Compact st\(base, N, L, P, "
                     r"false\)", src, re.S)
    assert re.search(r"dag_loss_only_kernel\(.*?compact_bytes\(N, L, P, "
                     r"false\)", src, re.S)
    threads, smem, gstride = K.dag_forward_plan(250, 9, 9)
    assert (threads, gstride) == (128, 0)
    assert smem == K.dag_forward_state_bytes(250 * 9, 250, 9)
