"""The arithmetic of the Hopper ``sausage_loss_only`` kernel, emulated on
the CPU.

``kernels/csrc/lattice_sausage.cu::sausage_loss_only_kernel`` builds no
cumsum grid: an arc's acoustic score is kappa times the direct sum of
``lp[t, label]`` over its span (a span of more than 32 frames summed by a
warp, lane j over frames j, j+32, ..., then an xor butterfly), frames
clamped to [0, T] and labels to [0, K), and the S-segment recursion then
runs on one warp with xor-butterfly reductions.  The CUDA kernel runs
only on a card; this file repeats that arithmetic in numpy float32 and
holds it to the port's plain version ``kernels.ref.sausage_loss_only_ref``
(the reference's mean-centred cumsum formula) and to the JAX package's
``sausage_loss_only`` Pallas kernel in interpret mode, at K = 6000 on
adversarial spans: zero-length spans, spans ending at frame T, label
K-1, -1 slots, a fully masked utterance, masked arcs with labels outside
[0, K) (the two references, whose gathers would fault, get them
clamped: a masked arc never reaches the recursion), T = 1, and T = 1000
with spans up to T; and on the CG batch's shape (B=8, T=200, S=50, W=3).

Tolerance: |d| <= 1e-3 + 1e-5 |ref|, ``chip_smoke.py``'s bound for the
kernel against the plain version: the direct span sum and the centred
cumsum difference round differently, and scores reach |s| ~ 4e3 at
T = 1000, where one f32 ulp is 2.4e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import lattice_fb as JK  # noqa: E402
from repro_torch.data.synthetic import asr_batch  # noqa: E402
from repro_torch.kernels import lattice_fb as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402

ATOL, RTOL = 1e-3, 1e-5
KAPPA = 0.5
NUM_STATES = 6000
NEG = np.float32(-1e30)
EPS = np.float32(1e-30)
SHORT_SPAN = 32                      # lattice_sausage.cu kShortSpan
f32 = np.float32


def butterfly_sum(lanes):
    """A warp's xor-butterfly sum of 32 lane values (every lane ends with
    the same total; lane 0's is returned)."""
    v = np.asarray(lanes, np.float32).copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(np.float32)
    return v[0]


def span_score(col, start, end, T, lm):
    """kappa * sum over the clamped span, +lm, as the kernel sums it."""
    s, e = min(max(start, 0), T), min(max(end, 0), T)
    lo, hi, sign = min(s, e), max(s, e), f32(-1.0 if e < s else 1.0)
    if hi - lo > SHORT_SPAN:
        lanes = []
        for lane in range(32):
            acc = f32(0)
            for t in range(lo + lane, hi, 32):
                acc = f32(acc + col[t])
            lanes.append(acc)
        acc = butterfly_sum(lanes)
    else:
        acc = f32(0)
        for t in range(lo, hi):
            acc = f32(acc + col[t])
    return f32(f32(f32(KAPPA) * f32(sign * acc)) + lm)


def segment_step(sc, co, mk, carry_log, carry_c):
    """segment_step over a row of W alternatives on 32 lanes."""
    W = sc.shape[0]
    mx = np.full(32, -np.inf, np.float32)
    anyv = False
    zl = np.zeros(32, np.float32)
    cl = np.zeros(32, np.float32)
    for base in range(0, W, 32):
        for lane in range(min(32, W - base)):
            a = base + lane
            valid = mk[a] > 0.5
            r = f32(sc[a] + carry_log) if valid else NEG
            mx[lane] = max(mx[lane], r)
            anyv |= bool(valid)
    m = mx.max()
    for base in range(0, W, 32):
        for lane in range(min(32, W - base)):
            a = base + lane
            r = f32(sc[a] + carry_log) if mk[a] > 0.5 else NEG
            zl[lane] = f32(zl[lane] + f32(np.exp(f32(r - m)) * mk[a]))
    zc = max(butterfly_sum(zl), EPS)
    for base in range(0, W, 32):
        for lane in range(min(32, W - base)):
            a = base + lane
            valid = mk[a] > 0.5
            r = f32(sc[a] + carry_log) if valid else NEG
            w = f32(f32(np.exp(f32(r - m)) * mk[a]) / zc)
            cl[lane] = f32(cl[lane] + w * (f32(co[a] + carry_c) if valid
                                           else f32(0)))
    c = butterfly_sum(cl)
    if anyv:
        return f32(np.log(zc) + m), c
    return carry_log, carry_c


def emulate(lp, start, end, label, lm, corr, mask, la):
    """The kernel on numpy inputs: (logZ (B,), c_avg (B,))."""
    B, T, Kc = lp.shape
    A = start.shape[1]
    S, W = la.shape[1:]
    logz = np.zeros(B, np.float32)
    cavg = np.zeros(B, np.float32)
    for b in range(B):
        sc = np.zeros(S * W, np.float32)
        co = np.zeros(S * W, np.float32)
        mk = np.zeros(S * W, np.float32)
        for i, a in enumerate(la[b].reshape(-1)):
            if not 0 <= a < A:
                continue
            co[i], mk[i] = corr[b, a], f32(mask[b, a])
            if mk[i] > 0.5:
                col = lp[b, :, min(max(label[b, a], 0), Kc - 1)]
                sc[i] = span_score(col, start[b, a], end[b, a], T, lm[b, a])
        carry = (f32(0), f32(0))
        for s in range(S):
            r = slice(s * W, (s + 1) * W)
            carry = segment_step(sc[r], co[r], mk[r], *carry)
        logz[b], cavg[b] = carry
    return logz, cavg


def span_case(seed, B, T, S, W, *, max_span, float_mask=False):
    """(kernel inputs, reference inputs) as numpy, ``chip_smoke.py``'s
    ``span_case`` adversarial arcs."""
    rng = np.random.default_rng(seed)
    A = S * W
    start = rng.integers(0, T + 1, (B, A)).astype(np.int32)
    span = (rng.random((B, A)) ** 2 * (max_span + 1)).astype(np.int32)
    end = np.minimum(start + span, T).astype(np.int32)
    end[:, 1::7] = start[:, 1::7]                    # zero-length spans
    end[:, 2::7] = T                                 # arcs ending at T
    if max_span >= T:
        start[:, 3::11], end[:, 3::11] = 0, T        # whole-utterance arcs
    label = rng.integers(0, NUM_STATES, (B, A)).astype(np.int32)
    label[:, ::5] = NUM_STATES - 1                   # the last column
    mask = rng.random((B, A)) > 0.15
    mask[B - 1] = False                              # an empty utterance
    bad = ~mask & (rng.random((B, A)) > 0.5)
    label_kernel = np.where(bad, np.where(rng.random((B, A)) > 0.5,
                                          label + NUM_STATES, -1 - label),
                            label).astype(np.int32)
    lm = rng.normal(size=(B, A)).astype(np.float32)
    corr = (rng.random((B, A)) > 0.6).astype(np.float32)
    la = np.stack([rng.permutation(A) for _ in range(B)]).astype(
        np.int32).reshape(B, S, W)
    la[:, ::3, W - 1] = -1                           # padded slots
    if float_mask:
        mask = np.where(mask, np.where(rng.random((B, A)) > 0.5, 1.0, 0.7),
                        0.0).astype(np.float32)
    lp = rng.normal(size=(B, T, NUM_STATES)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    return ((lp, start, end, label_kernel, lm, corr, mask, la),
            (lp, start, end, label, lm, corr, mask, la))


def cg_batch(seed=0):
    """The CG batch's shape: 8 synthetic sausages of T = 200 at K = 6000,
    (S, W) = (50, 3)."""
    lat = asr_batch(seed, batch=8, num_frames=200, num_states=NUM_STATES,
                    input_dim=4, device="cpu")["lattice"]
    rng = np.random.default_rng(seed)
    lp = rng.normal(size=(8, 200, NUM_STATES)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    args = (lp,) + tuple(getattr(lat, f).numpy() for f in (
        "start_t", "end_t", "label", "lm", "corr", "arc_mask",
        "level_arcs"))
    return args, args


CASES = {
    "cg_batch": cg_batch,
    "spans_t200": lambda: span_case(1, 4, 200, 50, 3, max_span=12),
    "spans_t1": lambda: span_case(2, 3, 1, 4, 3, max_span=1,
                                  float_mask=True),
    "spans_t1000": lambda: span_case(3, 3, 1000, 6, 5, max_span=1000,
                                     float_mask=True),
    "spans_t1000_a40": lambda: span_case(4, 2, 1000, 4, 40, max_span=300),
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
    want = R.sausage_loss_only_ref(*targs, kappa=KAPPA)
    _close(emu, [w.numpy() for w in want])
    # the wrapper takes the plain version for CPU tensors, with no launch
    n = K.sausage_loss_only.launches
    got = K.sausage_loss_only(*targs, kappa=KAPPA)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.sausage_loss_only.launches == n


def test_emulation_matches_jax_interpret_kernel(case):
    _, _, ref_args, emu = case
    want = JK.sausage_loss_only(*(jnp.asarray(a) for a in ref_args),
                                kappa=KAPPA, interpret=True)
    _close(emu, want)


def test_the_spans_reach_every_edge(case):
    name, args, ref_args, _ = case
    lp, start, end, label, _, _, mask, la = args
    T = lp.shape[1]
    named = la[la >= 0]
    if name == "cg_batch":
        assert la.shape[1:] == (50, 3) and lp.shape == (8, 200, NUM_STATES)
        return
    flat = lambda x: x.reshape(x.shape[0], -1)  # noqa: E731
    assert ((flat(end) == flat(start)).any() and (flat(end) == T).any()
            and (label == NUM_STATES - 1).any() and named.size < la.size)
    bad = (label < 0) | (label >= NUM_STATES)
    assert bad.any() and not (np.asarray(mask, bool) & bad).any()
    np.testing.assert_array_equal(np.where(bad, 0, label),
                                  np.where(bad, 0, ref_args[3]))
    if T == 1000 and la.shape[2] == 5:
        assert (end - start).max() == T           # warp-summed long spans


def test_long_span_sum_is_the_span_sum():
    """The lane-strided warp sum of a T = 1000 column equals its plain
    float64 sum to f32 rounding, whatever the span's alignment."""
    rng = np.random.default_rng(5)
    col = rng.normal(-8.7, 1.0, 1000).astype(np.float32)
    for lo, hi in ((0, 1000), (1, 34), (17, 999), (500, 533)):
        got = span_score(col, lo, hi, 1000, f32(0)) / f32(KAPPA)
        want = col[lo:hi].astype(np.float64).sum()
        assert abs(got - want) <= 1e-6 * abs(want) * (hi - lo) ** 0.5
        # an arc with end < start sums the span negated (cumsum difference)
        back = span_score(col, hi, lo, 1000, f32(0)) / f32(KAPPA)
        assert back == -got
