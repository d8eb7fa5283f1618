"""The sausage forward / backward kernels' segment-parallel scan, emulated.

``csrc/lattice_sausage.cu`` runs no chain of segment steps: the carry of
a sausage enters every valid row value additively, so each segment
reduces to a pair (lse_s, E_s) and alpha / beta come from exclusive
prefix / suffix sums of those pairs.  No CUDA kernel runs on the CPU, so
this file replays the kernel's plan in numpy float32, step for step:

  * ``segment_stats``: one pass over a segment's A alternatives with a
    running max, the exp-sum and the weighted correctness sum rescaled
    when the max moves; valid = m > 0.5, weights times m, z clamped to
    EPS; (0, 0) for a segment with no valid arc;
  * ``warp_scan``: the inclusive Hillis-Steele scan in the kernel's
    shuffle order (offsets 1, 2, 4, 8, 16) over chunks of 32 segments,
    plus the carry of the chunks before, then the exclusive shift (lane 0
    takes the carry); the backward scans the reversed segments;
  * the writes: alpha = sc + P_{s-1}, c_alpha = corr + C_{s-1}, beta =
    P'_{s+1}, c_beta = C'_{s+1} on valid arcs, NEG / 0 elsewhere, logZ and
    c_avg the last carry.

The emulation is held to the port's plain versions
(``kernels.ref.sausage_forward_ref`` / ``sausage_backward_ref``, the serial
chain) and to the JAX package's ``sausage_forward`` / ``sausage_backward``
run in interpret mode, as ``tests/test_torch_sausage.py`` runs them, on:
the training tiles (B, S, A) = (32, 50, 3) of a synthetic batch; S = 1,
31, 32, 33, 64 and 250 (chunk edges) at A = 1, 3 and 40 with padded tail
segments, a fully masked segment, a fully masked utterance and ragged last
alternatives; fractional masks (0.3 and 0.7 on one row); scores that put
|logZ| near 5e3.  It also checks the identity the design rests on: per
segment, the chain's new_in_log - in_log is lse_s.

Tolerance |d| <= 1e-3 + 1e-5 |ref|, the same as phase 2 of
``chip_smoke.py``: f32 on both sides, the scan adding the segments in a
tree order against the chain's serial order, and one f32 ulp is 4.9e-4
at |logZ| ~ 5e3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import lattice_fb as JK  # noqa: E402
from repro_torch.data.synthetic import asr_batch  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.lattice_engine.common import arc_scores  # noqa: E402

ATOL, RTOL = 1e-3, 1e-5
NEG = np.float32(-1e30)
EPS = np.float32(1e-30)
LANES = 32
f32 = np.float32


# ---------------------------------------------------------------------------
# the kernel's plan in numpy float32
# ---------------------------------------------------------------------------

def segment_stats(sc, co, mk):
    """(lse, E) of each row of A alternatives, (..., A) -> (...,) twice:
    ``lattice_sausage.cu::segment_stats``, vectorised over rows."""
    shape = sc.shape[:-1]
    mx = np.full(shape, -np.inf, f32)
    z = np.zeros(shape, f32)
    e = np.zeros(shape, f32)
    any_valid = np.zeros(shape, bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for a in range(sc.shape[-1]):
            m, s, c = mk[..., a], sc[..., a], co[..., a]
            valid = m > 0.5
            new = valid & (s > mx)
            old = valid & ~new
            r = np.exp(np.where(new, mx - s, f32(0)))
            p = np.exp(np.where(old, s - mx, f32(0))) * m
            z = np.where(new, z * r + m, np.where(old, z + p, z))
            e = np.where(new, e * r + m * c, np.where(old, e + p * c, e))
            mx = np.where(new, s, mx)
            any_valid |= valid
        zc = np.maximum(z, EPS)
        lse = np.where(any_valid, np.log(zc) + mx, f32(0))
        big_e = np.where(any_valid, e / zc, f32(0))
    return lse.astype(f32), big_e.astype(f32)


def warp_scan(v):
    """Inclusive Hillis-Steele scan over the last axis (32 lanes) in the
    kernel's order: at offset o, lane l >= o adds lane l - o's value."""
    lane = np.arange(LANES)
    for o in (1, 2, 4, 8, 16):
        y = np.concatenate([v[..., :o], v[..., :-o]], axis=-1)
        v = np.where(lane >= o, v + y, v)
    return v


def scan_segments(lse, big_e):
    """Exclusive sums of (lse, E) over (B, S) in scan order, chunks of 32
    lanes with the chunk carry; returns them and the totals (B,)."""
    B, S = lse.shape
    n = -(-S // LANES) * LANES
    pad = ((0, 0), (0, n - S))
    chunks = [np.pad(x, pad).reshape(B, n // LANES, LANES)
              for x in (lse, big_e)]
    carry = [np.zeros(B, f32), np.zeros(B, f32)]
    ex = [np.zeros((B, n), f32), np.zeros((B, n), f32)]
    for k in range(n // LANES):
        for i in range(2):
            inc = warp_scan(chunks[i][:, k]) + carry[i][:, None]
            ex[i][:, k * LANES] = carry[i]
            ex[i][:, k * LANES + 1:(k + 1) * LANES] = inc[:, :-1]
            carry[i] = inc[:, -1]
    return ex[0][:, :S], ex[1][:, :S], carry[0], carry[1]


def forward_plan(sc, co, mk):
    lse, big_e = segment_stats(sc, co, mk)
    p, c, logz, cavg = scan_segments(lse, big_e)
    valid = mk > 0.5
    alpha = np.where(valid, sc + p[..., None], NEG)
    c_alpha = np.where(valid, co + c[..., None], f32(0))
    return alpha, c_alpha, logz, cavg


def backward_plan(sc, co, mk):
    lse, big_e = segment_stats(sc, co, mk)
    p, c, _, _ = scan_segments(lse[:, ::-1], big_e[:, ::-1])
    p, c = p[:, ::-1], c[:, ::-1]
    valid = mk > 0.5
    return (np.where(valid, p[..., None], NEG),
            np.where(valid, c[..., None], f32(0)))


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def masked_tiles(B, S, A, seed, *, loc=0.0):
    """Padded tail segments (utterance 0), a fully masked segment
    (utterance 1), a fully masked utterance (2) and ragged last
    alternatives; scores N(loc, 3)."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(loc, 3, (B, S, A)).astype(f32)
    corr = (rng.random((B, S, A)) > 0.6).astype(f32)
    mask = np.ones((B, S, A), f32)
    mask[0, S // 2 + 1:] = 0.0
    mask[1, S // 3] = 0.0
    mask[2] = 0.0
    if A > 1:
        mask[:, :, A - 1] *= rng.random((B, S)) > 0.3
    return np.where(mask > 0, scores, NEG).astype(f32), corr, mask


def fractional_tiles(seed):
    """Masks of 0.3 and 0.7 on one row: the 0.7 arc is valid and weighs
    0.7, the 0.3 arc is masked; another row holds only 0.3 (a masked
    segment) and a third only 0.7."""
    _, corr, mask = masked_tiles(4, 9, 3, seed)
    mask[3, 2] = (1.0, 0.3, 0.7)
    mask[3, 4] = (0.3, 0.0, 0.3)
    mask[3, 6] = (0.0, 0.7, 0.0)
    mask[1, 5, :2] = (0.7, 0.7)
    scores = np.random.default_rng(seed + 1).normal(0, 3, mask.shape)
    return np.where(mask > 0, scores, NEG).astype(f32), corr, mask


def training_tiles():
    """The gradient batch's tiles as the CUDA backend builds them:
    synthetic sausages (seg_len 4, 3 arcs) of T = 200 frames, B = 32."""
    lat = asr_batch(0, batch=32, num_frames=200, num_states=60, input_dim=8,
                    device="cpu")["lattice"]
    rng = np.random.default_rng(5)
    lp = torch.from_numpy(rng.normal(0, 1, (32, 200, 60)).astype(f32))
    lp = lp.log_softmax(-1)
    la = lat.level_arcs
    scores = R.gather_sausage_ref(arc_scores(lat, lp, 0.5) + lat.lm, la,
                                  float(NEG))
    corr = R.gather_sausage_ref(lat.corr.float(), la, 0.0)
    mask = R.gather_sausage_ref(lat.arc_mask.float(), la, 0.0)
    return tuple(x.numpy().astype(f32) for x in (scores, corr, mask))


def _case(name):
    if name == "train_32x50x3":
        return training_tiles()
    if name == "fractional":
        return fractional_tiles(3)
    if name == "logz_5e3":
        # 250 segments of scores near -22.5: logZ about -5e3
        return masked_tiles(4, 250, 3, 4, loc=-22.5)
    S, A = (int(x) for x in name[1:].split("_a"))
    return masked_tiles(4, S, A, seed=S + A)


CASES = (["train_32x50x3", "fractional", "logz_5e3"]
         + [f"s{S}_a{A}" for A in (1, 3, 40)
            for S in (1, 31, 32, 33, 64, 250)])


@pytest.fixture(scope="module", params=CASES)
def case(request):
    tiles = _case(request.param)
    t = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in tiles)
    return request.param, tiles, t


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (what, i)
        bad = np.abs(g - w) > ATOL + RTOL * np.abs(w)
        assert not bad.any(), (
            f"{what} output {i}: {int(bad.sum())} entries off, max |d| "
            f"{float(np.abs(g - w).max()):.3g}")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_plan_matches_plain_versions(case):
    name, tiles, t = case
    _close(forward_plan(*tiles), [x.numpy() for x in
                                  R.sausage_forward_ref(*t)],
           f"forward[{name}]")
    _close(backward_plan(*tiles), [x.numpy() for x in
                                   R.sausage_backward_ref(*t)],
           f"backward[{name}]")


def test_plan_matches_jax_interpret_kernels(case):
    name, tiles, _ = case
    j = tuple(jnp.asarray(x) for x in tiles)
    _close(forward_plan(*tiles),
           [np.asarray(x) for x in JK.sausage_forward(*j, interpret=True)],
           f"forward[{name}]")
    _close(backward_plan(*tiles),
           [np.asarray(x) for x in JK.sausage_backward(*j, interpret=True)],
           f"backward[{name}]")


def test_segment_lse_is_the_chains_carry_increment(case):
    """The chain's step moves in_log by lse_s and c_in by E_s (the c_in
    step exactly so only because the weights of a valid segment sum to
    1), from any carry: here the plain version's own carries."""
    name, tiles, t = case
    lse, big_e = segment_stats(*tiles)
    sc, co, mk = t
    in_log = torch.zeros(sc.shape[0])
    c_in = torch.zeros(sc.shape[0])
    for s in range(sc.shape[1]):
        valid, seg_valid, _, new_log, w = R._sausage_step(
            sc[:, s], co[:, s], mk[:, s], in_log, c_in)
        c_row = torch.where(valid, co[:, s] + c_in[:, None],
                            torch.zeros_like(co[:, s]))
        new_c = torch.where(seg_valid, (w * c_row).sum(-1), c_in)
        _close([(new_log - in_log).numpy(), (new_c - c_in).numpy()],
               [lse[:, s], big_e[:, s]], f"segment {s} of {name}")
        in_log, c_in = new_log, new_c


def test_fully_masked_utterance_keeps_the_zero_carry():
    tiles = masked_tiles(4, 33, 3, seed=1)
    alpha, c_alpha, logz, cavg = forward_plan(*tiles)
    beta, c_beta = backward_plan(*tiles)
    assert logz[2] == 0.0 and cavg[2] == 0.0
    assert (alpha[2] == NEG).all() and (beta[2] == NEG).all()
    assert (c_alpha[2] == 0).all() and (c_beta[2] == 0).all()


def test_warp_scan_is_an_inclusive_prefix_sum():
    rng = np.random.default_rng(0)
    v = rng.integers(-50, 50, (5, LANES)).astype(f32)   # exact in f32
    np.testing.assert_array_equal(warp_scan(v), np.cumsum(v, -1))


@pytest.mark.parametrize("S", [1, 31, 32, 33, 64, 250])
def test_chunk_carry_and_exclusive_shift(S):
    """Integer-valued (lse, E), exact in f32: the exclusive sums and the
    totals equal numpy's, across every chunk edge."""
    rng = np.random.default_rng(S)
    lse = rng.integers(-9, 9, (3, S)).astype(f32)
    big_e = rng.integers(0, 3, (3, S)).astype(f32)
    p, c, tot_p, tot_c = scan_segments(lse, big_e)
    for got, x, tot in ((p, lse, tot_p), (c, big_e, tot_c)):
        want = np.cumsum(x, -1) - x
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tot, x.sum(-1))
