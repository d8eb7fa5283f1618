"""The compaction plan of the Hopper ``dag_forward`` kernel, emulated on
the CPU.

``kernels/csrc/lattice_dag.cu::dag_forward_kernel`` runs the forward
recursion over the valid slots only: compact ids 1..N by an exclusive
scan of the ``ok`` flags in flat level-major order, level offsets, a
position -> id map whose reserved id 0 holds NEG / 0 (the dump slot,
non-valid slots and predecessors on the slot's own or a later level
read it), predecessor rows translated entry by entry, the recursion
level by level over the compact arrays, and a sequential fold over the
final slots in compact order; also the rule by which the kernel picks
its chain (one warp, or the block with a barrier a level) and the place
of its compact state (shared or global memory).  The CUDA kernel runs only on a card; this file repeats
its plan step by step in numpy float32 (slot rows and the fold summed
sequentially, as the kernel does) and holds the result to the port's
plain version ``kernels.ref.dag_forward_ref`` and to the JAX package's
``dag_forward`` Pallas kernel in interpret mode, on the five corpus
cases, a random-DAG B=8 bucket, a streaming session's bucket (W = A)
and the resume lattice of a session, whose fold must equal the
from-scratch fold bit for bit.

Tolerance: rtol = atol = 1e-5 (f32 on every side; the plain version and
XLA sum rows in other orders than the sequential emulation).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import lattice_fb as JK  # noqa: E402
from repro_torch.analysis.corpus import ADVERSARIAL_CASES  # noqa: E402
from repro_torch.kernels import lattice_fb as K  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.lattice_engine.common import arc_scores  # noqa: E402
from repro_torch.lattice_engine.cuda_backend import dag_level_tensors  # noqa: E402,E501
from repro_torch.losses.lattice import (batch_lattices,  # noqa: E402
                                        lattice_frontiers,
                                        make_random_dag_lattice)
from repro_torch.serving import packing  # noqa: E402
from repro_torch.serving.streaming import (StreamSession,  # noqa: E402
                                           resume_lattice_dict,
                                           session_bucket, truncate_levels)

NEG = np.float32(-1e30)
HALF_NEG = np.float32(-5e29)
EPS = np.float32(1e-30)
KAPPA = 0.5
RTOL = ATOL = 1e-5


def compact_plan(ok, pidx):
    """One utterance's plan: (N, map (L*W+1,), off (L+1,), pos (N,),
    translated predecessor ids (N, P)).  ok: (L, W); pidx: (L, W, P)."""
    L, W = ok.shape
    P = pidx.shape[-1]
    valid = ok.reshape(-1) > 0.5
    q = np.cumsum(valid) - valid                  # valid slots before s
    n = int(valid.sum())
    mp = np.append(np.where(valid, q + 1, ~q), ~n)
    prefix = np.where(mp > 0, mp - 1, ~mp)
    off = prefix[np.arange(L + 1) * W] if W else np.zeros(L + 1, int)
    pos = np.flatnonzero(valid)
    rows = pidx.reshape(-1, P)[pos]
    level_start = (pos // max(W, 1) * W)[:, None]
    pred = np.where((rows >= 0) & (rows < level_start),
                    np.maximum(mp[np.clip(rows, 0, L * W)], 0), 0)
    return n, mp, off, pos, pred


def _lse_row(xs, cs):
    """The kernel's masked_lse_row, sequentially in float32."""
    has, m = False, NEG
    for x in xs:
        if x > HALF_NEG:
            has, m = True, max(m, x)
    m0 = m if has else np.float32(0)
    z = np.float32(0)
    for x in xs:
        if x > HALF_NEG:
            z = np.float32(z + np.exp(np.float32(x - m0)))
    zc = max(z, EPS)
    lse = max(np.float32(np.log(zc) + m0), NEG) if has else NEG
    c = np.float32(0)
    for x, cv in zip(xs, cs):
        if x > HALF_NEG:
            c = np.float32(c + np.float32(np.exp(np.float32(x - m0)) / zc)
                           * cv)
    return lse, c


def emulate(own, corr, start, ok, final, pidx):
    """The kernel's plan on (B, L, W[, P]) numpy inputs: (alpha, c_alpha,
    logZ, c_avg, per-utterance plans)."""
    B, L, W = own.shape
    alpha = np.empty((B, L * W), np.float32)
    c_alpha = np.empty((B, L * W), np.float32)
    logz = np.empty(B, np.float32)
    cavg = np.empty(B, np.float32)
    plans = []
    for b in range(B):
        n, mp, off, pos, pred = compact_plan(ok[b], pidx[b])
        plans.append((n, mp, off, pos, pred))
        st = start[b].reshape(-1)[pos] > 0.5
        fn = final[b].reshape(-1)[pos] > 0.5
        x = np.append(NEG, own[b].reshape(-1)[pos]).astype(np.float32)
        c = np.append(np.float32(0), corr[b].reshape(-1)[pos]).astype(
            np.float32)
        c[1:][st] += np.float32(0)            # corr + 0 at start slots
        for lv in range(L):
            for i in range(off[lv] + 1, off[lv + 1] + 1):
                if st[i - 1]:
                    continue
                ids = pred[i - 1]
                lse, c_in = _lse_row(x[ids], c[ids])
                x[i] = np.float32(x[i] + lse)
                c[i] = np.float32(c[i] + c_in)
        logz[b], cavg[b] = fold(x, c, fn)
        ids = np.maximum(mp[:-1], 0)
        alpha[b], c_alpha[b] = x[ids], c[ids]
    return (alpha.reshape(B, L, W), c_alpha.reshape(B, L, W), logz, cavg,
            plans)


def fold(x, c, fn):
    """logZ / c_avg over the final ids in compact order, sequentially."""
    keep = np.flatnonzero(fn & (x[1:] > HALF_NEG)) + 1
    has = keep.size > 0
    m0 = x[keep].max() if has else np.float32(0)
    z = np.float32(0)
    for i in keep:
        z = np.float32(z + np.exp(np.float32(x[i] - m0)))
    zc = max(z, EPS)
    cs = np.float32(0)
    for i in keep:
        cs = np.float32(cs + np.float32(np.exp(np.float32(x[i] - m0)) / zc)
                        * c[i])
    return (max(np.float32(np.log(zc) + m0), NEG) if has else NEG), cs


def level_inputs(lat, lp):
    fr = lattice_frontiers(lat)
    own, corr, start, ok, final = dag_level_tensors(
        lat, arc_scores(lat, lp, KAPPA) + lat.lm, fr)
    return tuple(t.numpy() for t in (own, corr, start, ok, final, fr.pidx))


def _lp(rng, B, T, Kc):
    lp = rng.normal(0, 1, (B, T, Kc)).astype(np.float32)
    return torch.from_numpy(lp - np.log(np.exp(lp).sum(-1, keepdims=True)))


def _corpus(name):
    lat, T, Kc = ADVERSARIAL_CASES[name](0, device="cpu")
    return level_inputs(lat, _lp(np.random.default_rng(1),
                                 lat.start_t.shape[0], T, Kc))


def _dag_bucket():
    rng = np.random.default_rng(3)
    dicts = [make_random_dag_lattice(rng, num_frames=60, num_states=7)
             for _ in range(8)]
    spec = packing.derive_buckets(dicts, batch=8, tiers=1)[0]
    lat, _ = packing.pack_requests(dicts, spec, device="cpu")
    return level_inputs(lat, _lp(rng, 8, spec.num_frames, 7))


def _session_parts(seed=4, frames=80):
    rng = np.random.default_rng(seed)
    d = make_random_dag_lattice(rng, num_frames=frames, num_states=7)
    spec = session_bucket(d)
    lp = _lp(rng, 1, spec.num_frames, 7)
    return d, spec, lp


def _session_bucket():
    d, spec, lp = _session_parts()
    lat, _ = packing.pack_requests([d], spec, device="cpu")
    return level_inputs(lat, lp)


CASES = {**{f"corpus_{n}": (lambda n=n: _corpus(n))
            for n in sorted(ADVERSARIAL_CASES)},
         "dag_b8": _dag_bucket, "session_bucket": _session_bucket}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    args = CASES[request.param]()
    return request.param, args, emulate(*args)


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_emulation_matches_plain_version(case):
    _, args, emu = case
    want = R.dag_forward_ref(*(torch.from_numpy(a) for a in args))
    _close(emu[:4], [w.numpy() for w in want])


def test_emulation_matches_jax_interpret_kernel(case):
    _, args, emu = case
    want = JK.dag_forward(*(jnp.asarray(a) for a in args), interpret=True)
    _close(emu[:4], want)


def test_plan_is_level_major_and_reserves_id_zero(case):
    _, (own, corr, start, ok, final, pidx), emu = case
    B, L, W = own.shape
    for b, (n, mp, off, pos, pred) in enumerate(emu[4]):
        counts = (ok[b] > 0.5).sum(-1)
        assert off[0] == 0 and off[L] == n
        np.testing.assert_array_equal(np.diff(off), counts)
        # level l's valid slots are the ids off[l]+1 .. off[l+1], in order
        np.testing.assert_array_equal(pos // max(W, 1),
                                      np.repeat(np.arange(L), counts))
        assert mp[L * W] <= 0                       # the dump slot -> id 0
        np.testing.assert_array_equal(mp[pos], np.arange(1, n + 1))
        # entry j of a row is id 0 exactly where position j is not a
        # valid slot on an earlier level, else that slot's id
        lvl = pos // max(W, 1)
        rows = pidx[b].reshape(-1, pidx.shape[-1])[pos]
        inside = (rows >= 0) & (rows < L * W)
        earlier = inside & (np.where(inside, rows, 0) // max(W, 1)
                            < lvl[:, None])
        target = ok[b].reshape(-1)[np.where(inside, rows, 0)] > 0.5
        np.testing.assert_array_equal(pred > 0, earlier & target)
        np.testing.assert_array_equal(
            pos[np.maximum(pred - 1, 0)][pred > 0], rows[pred > 0])
        assert (pred >= 0).all() and (pred <= n).all()
        ok_pred = pred > 0
        assert (lvl[np.maximum(pred - 1, 0)][ok_pred]
                < np.broadcast_to(lvl[:, None], pred.shape)[ok_pred]).all()


def test_state_bytes_and_launch_plan():
    assert K.dag_forward_state_bytes(0, 1, 1) == 9 + 8
    assert K.dag_forward_state_bytes(750, 204, 8) == \
        9 * 751 + 4 * 205 + 4 * 750 * 8
    # a session bucket's all-valid worst case exceeds shared memory, so
    # the wrapper sizes the global state; the training batch fits
    threads, smem, gstride = K.dag_forward_plan(204, 750, 8)
    assert threads == 512 and smem == K.SMEM_MAX and gstride % 16 == 0
    assert gstride >= K.dag_forward_state_bytes(204 * 750, 204, 8)
    threads, smem, gstride = K.dag_forward_plan(24, 9, 9)
    assert (threads, gstride) == (128, 0)
    assert smem == K.dag_forward_state_bytes(24 * 9, 24, 9)


def test_resume_fold_equals_scratch_fold_bitwise():
    """The session's resume lattice (``truncate_levels`` +
    ``resume_lattice_dict``): completed arcs collapse into level 0 as
    virtual start arcs carrying the checkpointed alpha.  The kernel's
    fold runs over the final slots in compact order; on the resume
    lattice and from scratch that sequence holds the same values, so
    the emulated folds agree bit for bit (and with the plain version)."""
    d, spec, lp = _session_parts(seed=6, frames=120)
    sess = StreamSession(spec, kappa=KAPPA, backend="cuda", device="cpu")
    cut = max(1, d["level_arcs"].shape[0] // 2)
    sess.rescore(truncate_levels(d, cut), lp[0].numpy())
    done, alpha, c_alpha = sess.checkpoint
    padded = packing.pad_to_bucket(d, spec)
    rd = resume_lattice_dict(padded, done, alpha, c_alpha)
    lat_resume = batch_lattices([packing.pad_to_bucket(rd, spec)],
                                device="cpu")
    lat_scratch, _ = packing.pack_requests([padded], spec, device="cpu")
    folds = []
    for lat in (lat_resume, lat_scratch):
        args = level_inputs(lat, lp)
        emu = emulate(*args)
        want = R.dag_forward_ref(*(torch.from_numpy(a) for a in args))
        _close(emu[2:4], [w.numpy() for w in want[2:]])
        folds.append(emu[2:4])
    assert lat_resume.level_arcs.shape == lat_scratch.level_arcs.shape
    for a, b in zip(*folds):
        assert a.tobytes() == b.tobytes()


def test_branch_rule_counts_only_stepping_slots():
    """``lattice_fb.dag_branches("dag_forward", ...)`` (the rule of
    ``dag_loss_only`` too, which holds the same state): the block-barrier
    chain only when a level has more than 32 valid slots that take a step
    (a start slot takes none), the global state only when the valid
    slots' state exceeds SMEM_MAX; one rule per utterance."""
    from repro_torch.losses.lattice import make_sausage_lattice
    rng = np.random.default_rng(5)
    dicts = [make_sausage_lattice(rng, num_frames=f, num_states=7, n_alt=a)
             for f, a in ((40, 40), (40, 20))]
    spec = packing.derive_buckets(dicts, batch=2, tiers=1)[0]
    lat, _ = packing.pack_requests(dicts, spec, device="cpu")
    own, corr, start, ok, final, pidx = (
        torch.from_numpy(a) for a in level_inputs(lat, _lp(rng, 2,
                                                           spec.num_frames,
                                                           7)))
    P = pidx.shape[-1]
    for kernel in ("dag_forward", "dag_loss_only"):
        assert K.dag_branches(kernel, start, ok, P) == [("block", "shared"),
                                                       ("warp", "shared")]
    # every valid slot a start slot: no step, so no wide level
    assert K.dag_branches("dag_forward", ok, ok, P) == \
        [("warp", "shared")] * 2
    # 5,000 valid slots at P = 40 exceed shared memory
    many = torch.ones(1, 125, 40)
    assert K.dag_forward_state_bytes(5000, 125, 40) > K.SMEM_MAX
    assert K.dag_branches("dag_forward", torch.zeros_like(many), many,
                          40) == [("block", "global")]
    assert K.dag_branches("dag_forward", torch.zeros(3, 0, 4),
                          torch.zeros(3, 0, 4), 2) == [("warp", "shared")] * 3
