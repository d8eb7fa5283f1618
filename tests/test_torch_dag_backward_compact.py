"""The compacted plan of the Hopper ``dag_backward`` kernel, emulated on
the CPU.

``kernels/csrc/lattice_dag.cu::dag_backward_kernel`` runs the backward
recursion over the valid slots only, on ``dag_forward``'s compaction
(compact ids by an exclusive scan of the ``ok`` flags in flat level-major
order, level offsets, a position -> id map whose reserved id 0 holds
NEG / 0), with successor rows translated by the mirror of the forward
rule: a successor keeps its compact id only when it is a valid slot on a
strictly later level; the dump slot, out-of-range positions, non-valid
slots and successors on the slot's own or an earlier level read id 0.
The chain then runs from the last level to the first, each non-final
slot through ``masked_lse_row`` over beta + own and c_beta + corr of its
successors, in row order.  The CUDA kernel runs only on a card; this
file repeats its plan in numpy float32 (rows summed sequentially, as the
kernel does) and holds it to the port's plain version
``kernels.ref.dag_backward_ref`` and to the JAX package's
``dag_backward`` Pallas kernel in interpret mode, on the five corpus
cases, a random-DAG B=8 bucket, the service bucket's shape at small K
and a case whose successor rows point at random into the slot's own,
earlier and later levels and the dump slot; it also holds the compacted
chain bit for bit, on every case, to the per-slot global-memory
recursion the kernel replaced (each level read before it is written,
which is that kernel's arithmetic wherever no row points into its own
level), and the state bytes,
launch plan and branch rule (``lattice_fb.dag_backward_state_bytes``,
``dag_backward_plan``, ``dag_branches``) to the kernel source's rule.

Tolerance: rtol = atol = 1e-5 (f32 on every side; the plain version and
XLA sum rows in other orders than the sequential emulation).
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
from repro_torch.lattice_engine.common import arc_scores  # noqa: E402
from repro_torch.lattice_engine.cuda_backend import dag_level_tensors  # noqa: E402,E501
from repro_torch.losses.lattice import (lattice_frontiers,  # noqa: E402
                                        make_random_dag_lattice,
                                        make_sausage_lattice)
from repro_torch.serving import packing  # noqa: E402
from test_torch_dag_compact import _lp, _lse_row, compact_plan  # noqa: E402

NEG = np.float32(-1e30)
KAPPA = 0.5
RTOL = ATOL = 1e-5


def successor_rows(mp, pos, sidx, L, W):
    """Translated successor ids (N, S): a valid slot on a strictly later
    level keeps its id, every other entry reads id 0."""
    S = sidx.shape[-1]
    rows = sidx.reshape(-1, S)[pos]
    level_end = ((pos // max(W, 1) + 1) * W)[:, None]
    keep = (rows >= level_end) & (rows < L * W)
    return np.where(keep, np.maximum(mp[np.clip(rows, 0, L * W)], 0), 0)


def emulate(own, corr, final, ok, sidx):
    """The kernel's plan on (B, L, W[, S]) numpy inputs: (beta, c_beta,
    per-utterance (N, map, off, pos, successor rows))."""
    B, L, W = own.shape
    beta = np.empty((B, L * W), np.float32)
    c_beta = np.empty((B, L * W), np.float32)
    plans = []
    for b in range(B):
        n, mp, off, pos, _ = compact_plan(ok[b], sidx[b])
        succ = successor_rows(mp, pos, sidx[b], L, W)
        plans.append((n, mp, off, pos, succ))
        fn = final[b].reshape(-1)[pos] > 0.5
        x = np.zeros(n + 1, np.float32)
        c = np.zeros(n + 1, np.float32)
        x[0] = NEG
        o = np.append(np.float32(0), own[b].reshape(-1)[pos]).astype(
            np.float32)
        co = np.append(np.float32(0), corr[b].reshape(-1)[pos]).astype(
            np.float32)
        for lv in range(L - 1, -1, -1):
            for i in range(off[lv] + 1, off[lv + 1] + 1):
                if fn[i - 1]:
                    continue                  # final: beta = 0, c_beta = 0
                ids = succ[i - 1]
                x[i], c[i] = _lse_row(x[ids] + o[ids], c[ids] + co[ids])
        ids = np.maximum(mp[:-1], 0)
        beta[b], c_beta[b] = x[ids], c[ids]
    return beta.reshape(B, L, W), c_beta.reshape(B, L, W), plans


def global_recursion(own, corr, final, ok, sidx):
    """The per-slot global-memory recursion the compacted kernel replaced
    (levels L-1 .. 0 over all W slots, a successor read from the (L*W+1)
    buffers as beta + own where it is ok, NEG / 0 at the dump slot), in
    numpy float32, with each level written only after all its slots are
    computed, as the plain version and the JAX kernel do (the replaced
    kernel wrote slot by slot, so a row into its own level raced)."""
    B, L, W = own.shape
    LW = L * W
    out_b = np.empty((B, LW), np.float32)
    out_c = np.empty((B, LW), np.float32)
    for b in range(B):
        okf = ok[b].reshape(-1) > 0.5
        fin = final[b].reshape(-1) > 0.5
        o, co = own[b].reshape(-1), corr[b].reshape(-1)
        rows = sidx[b].reshape(LW, -1)
        bb = np.full(LW + 1, NEG, np.float32)
        cb = np.zeros(LW + 1, np.float32)
        for lv in range(L - 1, -1, -1):
            level = []
            for s in range(lv * W, (lv + 1) * W):
                bv, cv = NEG, np.float32(0)
                if okf[s]:
                    if fin[s]:
                        bv = cv = np.float32(0)
                    else:
                        p = np.where((rows[s] >= 0) & (rows[s] < LW),
                                     rows[s], LW)
                        xs = np.where(p == LW, NEG, bb[p] + np.where(
                            okf[np.minimum(p, LW - 1)],
                            o[np.minimum(p, LW - 1)], NEG)).astype(
                                np.float32)
                        cs = np.where(p == LW, np.float32(0), cb[p] + np.where(
                            okf[np.minimum(p, LW - 1)],
                            co[np.minimum(p, LW - 1)], 0)).astype(np.float32)
                        bv, cv = _lse_row(xs, cs)
                level.append((bv, cv))
            bb[lv * W:(lv + 1) * W] = [v[0] for v in level]
            cb[lv * W:(lv + 1) * W] = [v[1] for v in level]
        out_b[b], out_c[b] = bb[:LW], cb[:LW]
    return out_b.reshape(B, L, W), out_c.reshape(B, L, W)


def backward_inputs(lat, lp):
    fr = lattice_frontiers(lat)
    own, corr, _, ok, final = dag_level_tensors(
        lat, arc_scores(lat, lp, KAPPA) + lat.lm, fr)
    return tuple(t.numpy() for t in (own, corr, final, ok, fr.sidx))


def _corpus(name):
    lat, T, Kc = ADVERSARIAL_CASES[name](0, device="cpu")
    return backward_inputs(lat, _lp(np.random.default_rng(1),
                                    lat.start_t.shape[0], T, Kc))


def _bucket(seed, frames):
    rng = np.random.default_rng(seed)
    dicts = [make_random_dag_lattice(rng, num_frames=frames, num_states=7)
             for _ in range(8)]
    spec = packing.derive_buckets(dicts, batch=8, tiers=1)[0]
    lat, _ = packing.pack_requests(dicts, spec, device="cpu")
    return backward_inputs(lat, _lp(rng, 8, spec.num_frames, 7))


def _cross_level():
    """dag_b8's inputs with successor positions drawn over [0, L*W]: the
    slot's own level, earlier and later levels and the dump slot."""
    own, corr, final, ok, sidx = _bucket(3, 60)
    B, L, W, S = sidx.shape
    rng = np.random.default_rng(8)
    wild = rng.integers(0, L * W + 1, sidx.shape).astype(np.int32)
    return own, corr, final, ok, wild


CASES = {**{f"corpus_{n}": (lambda n=n: _corpus(n))
            for n in sorted(ADVERSARIAL_CASES)},
         "dag_b8": lambda: _bucket(3, 60),
         # the service bucket's shape (8, ~250, 9): random DAGs of T = 1000
         "service_bucket": lambda: _bucket(11, 1000),
         "cross_level_succs": _cross_level}


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
    targs = [torch.from_numpy(a) for a in args]
    want = R.dag_backward_ref(*targs)
    _close(emu[:2], [w.numpy() for w in want])
    # the wrapper takes the plain version for CPU tensors, with no launch
    n = K.dag_backward.launches
    got = K.dag_backward(*targs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.dag_backward.launches == n


def test_emulation_matches_jax_interpret_kernel(case):
    _, args, emu = case
    want = JK.dag_backward(*(jnp.asarray(a) for a in args), interpret=True)
    _close(emu[:2], want)


def test_successor_rows_keep_only_valid_slots_on_later_levels(case):
    name, (own, corr, final, ok, sidx), emu = case
    B, L, W = own.shape
    n_own_level = 0
    for b, (n, mp, off, pos, succ) in enumerate(emu[2]):
        np.testing.assert_array_equal(np.diff(off), (ok[b] > 0.5).sum(-1))
        lvl = pos // max(W, 1)
        rows = sidx[b].reshape(-1, sidx.shape[-1])[pos]
        inside = (rows >= 0) & (rows < L * W)
        tgt_lvl = np.where(inside, rows, 0) // max(W, 1)
        later = inside & (tgt_lvl > lvl[:, None])
        target = ok[b].reshape(-1)[np.where(inside, rows, 0)] > 0.5
        np.testing.assert_array_equal(succ > 0, later & target)
        np.testing.assert_array_equal(pos[np.maximum(succ - 1, 0)][succ > 0],
                                      rows[succ > 0])
        assert (succ >= 0).all() and (succ <= n).all()
        n_own_level += int((inside & (tgt_lvl == lvl[:, None])
                            & target).sum())
    if name == "cross_level_succs":
        # the case reaches own-level, earlier-level and later-level slots
        assert n_own_level > 0


def test_compact_chain_equals_the_global_recursion_bitwise(case):
    """The compacted chain reads the same values in the same row order as
    the per-slot global-memory recursion (entries that read id 0 are
    masked there too): the same bits, so on inputs without own-level rows
    the same bits as the replaced kernel."""
    _, args, emu = case
    want = global_recursion(*args)
    for g, w in zip(emu[:2], want):
        assert g.tobytes() == w.tobytes()


def _source_rule(R_, n, L, backward):
    """lattice_dag.cu's compact_bytes, evaluated from its source text."""
    src = (CSRC / "lattice_dag.cu").read_text()
    expr = re.search(r"compact_bytes\(long long N,.*?return (.*?);", src,
                     re.S).group(1)
    expr = expr.replace("4LL", "4").replace("(backward ? 17 : 9)",
                                            "(17 if backward else 9)")
    return eval(expr, {"N": n, "L": L, "R": R_, "backward": backward})


def test_state_bytes_and_launch_plan():
    for n, L, S in ((0, 1, 1), (216, 24, 9), (750, 204, 8), (10000, 250, 40)):
        assert K.dag_backward_state_bytes(n, L, S) == \
            _source_rule(S, n, L, True)
        assert K.dag_forward_state_bytes(n, L, S) == \
            _source_rule(S, n, L, False)
    assert K.dag_backward_state_bytes(750, 204, 8) == \
        17 * 751 + 4 * 205 + 4 * 750 * 8
    # the DAG-training batch fits shared memory; a session bucket's
    # all-valid worst case does not, so the wrapper sizes the global state
    threads, smem, gstride = K.dag_backward_plan(24, 9, 9)
    assert (threads, gstride) == (128, 0)
    assert smem == K.dag_backward_state_bytes(24 * 9, 24, 9)
    threads, smem, gstride = K.dag_backward_plan(204, 750, 8)
    assert threads == 512 and smem == K.SMEM_MAX and gstride % 16 == 0
    assert gstride >= K.dag_backward_state_bytes(204 * 750, 204, 8)
    src = (CSRC / "lattice_dag.cu").read_text()
    assert f"kScanItems = {K.SCAN_ITEMS};" in src


def test_branch_rule_counts_only_stepping_slots():
    """``dag_branches("dag_backward", final, ok, S)``: the block-barrier
    chain only when a level has more than 32 valid slots that take a step
    (a final slot takes none), the global state only when the valid
    slots' backward state exceeds SMEM_MAX."""
    rng = np.random.default_rng(5)
    dicts = [make_sausage_lattice(rng, num_frames=f, num_states=7, n_alt=a)
             for f, a in ((40, 40), (40, 20))]
    spec = packing.derive_buckets(dicts, batch=2, tiers=1)[0]
    lat, _ = packing.pack_requests(dicts, spec, device="cpu")
    own, corr, final, ok, sidx = (torch.from_numpy(a) for a in
                                  backward_inputs(lat, _lp(rng, 2,
                                                           spec.num_frames,
                                                           7)))
    S = sidx.shape[-1]
    assert K.dag_branches("dag_backward", final, ok, S) == \
        [("block", "shared"), ("warp", "shared")]
    # every valid slot final: no step, so no wide level
    assert K.dag_branches("dag_backward", ok, ok, S) == \
        [("warp", "shared")] * 2
    # 2,500 valid slots at S = 20 fit the forward's state in shared
    # memory, not the backward's (own and corr too)
    many = torch.ones(1, 125, 20)
    assert K.dag_forward_state_bytes(2500, 125, 20) <= K.SMEM_MAX
    assert K.dag_backward_state_bytes(2500, 125, 20) > K.SMEM_MAX
    none = torch.zeros_like(many)
    assert K.dag_branches("dag_forward", none, many, 20) == \
        [("warp", "shared")]
    assert K.dag_branches("dag_backward", none, many, 20) == \
        [("warp", "global")]
