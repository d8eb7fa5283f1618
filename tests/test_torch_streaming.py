"""Port streaming: checkpoint + virtual-start resume, and carry-over of a
JAX session's checkpoint into a port session.

Within the port, resuming a grown partial lattice from an alpha-frontier
checkpoint equals from-scratch rescoring BITWISE on the CPU path, on both
backends: a zero-span virtual start arc carries the checkpointed
alpha/c_alpha exactly, and the session pins one input shape, so every
reduction runs over the same operands in the same order.

Across packages: a JAX ``StreamSession`` (Pallas kernel path) checkpoints
a partial lattice; its ``checkpoint`` goes through ``convert`` into a port
session, whose resumed result must equal JAX's from-scratch result within
rtol 1e-5 / atol 1e-4 (f32; XLA and PyTorch sum in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving.streaming import StreamSession as JaxSession  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import corpus  # noqa: E402
from repro_torch.losses.lattice import (levelize_arcs,  # noqa: E402
                                        make_random_dag_lattice,
                                        make_sausage_lattice)
from repro_torch.serving.streaming import (StreamSession,  # noqa: E402
                                           resume_lattice_dict,
                                           session_bucket, truncate_levels)

KAPPA = 0.5
K = 6
RTOL, ATOL = 1e-5, 1e-4
BACKENDS = ("levelized", "cuda")

CASES = {
    "sausage": lambda rng: make_sausage_lattice(
        rng, num_frames=16, num_states=K, seg_len=4, n_alt=3),
    "dag": lambda rng: make_random_dag_lattice(
        rng, num_frames=16, num_states=K),
    "single_level": lambda rng: corpus._single_level_dict(
        rng, num_states=K),
    "max_fanin": lambda rng: corpus._max_fanin_dict(rng, num_states=K),
    "zero_arc": lambda rng: corpus._zero_arc_dict(rng, num_states=K),
}


def _case(name, seed=0):
    rng = np.random.default_rng(seed)
    d = CASES[name](rng)
    t = d["ref_states"].shape[0]
    lp = rng.normal(0, 1, (t, K)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    return d, lp


def _session(d, backend, **kw):
    return StreamSession(session_bucket(d), kappa=KAPPA, backend=backend,
                         device="cpu", **kw)


def _assert_bits(a, b):
    assert np.asarray(a.logZ) == np.asarray(b.logZ)
    assert np.asarray(a.c_avg) == np.asarray(b.c_avg)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_bit_equal_from_scratch(case, backend):
    d, lp = _case(case)
    sess = _session(d, backend)
    cut = max(1, d["level_arcs"].shape[0] // 2)
    sess.rescore(truncate_levels(d, cut), lp)
    resumed = sess.rescore(d, lp)
    _assert_bits(resumed, sess.rescore_from_scratch(d, lp))
    assert sess.traces == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_multi_step_growth_stays_exact(backend):
    d, lp = _case("dag", seed=3)
    sess = _session(d, backend)
    L = d["level_arcs"].shape[0]
    for cut in sorted({1, L // 3, (2 * L) // 3, L}):
        snap = truncate_levels(d, max(cut, 1))
        _assert_bits(sess.rescore(snap, lp),
                     sess.rescore_from_scratch(snap, lp))
    assert sess.traces == 1


def test_checkpoint_matches_full_run_alpha():
    d, lp = _case("dag", seed=1)
    sess = _session(d, "cuda")
    cut = max(1, d["level_arcs"].shape[0] // 2)
    sess.rescore(truncate_levels(d, cut), lp)
    sess.rescore(d, lp)
    done, alpha, c_alpha = sess.checkpoint
    a_full, c_full, _ = _session(d, "cuda")._dispatch(d, lp)
    np.testing.assert_array_equal(alpha[done], a_full[done])
    np.testing.assert_array_equal(c_alpha[done], c_full[done])


def test_resume_lattice_collapses_completed_levels():
    d, lp = _case("sausage")
    L = d["level_arcs"].shape[0]
    cut = 2
    sess = _session(d, "levelized")
    sess.rescore(truncate_levels(d, cut), lp)
    done, alpha, c_alpha = sess.checkpoint
    rd = resume_lattice_dict(d, done, alpha, c_alpha)
    assert rd["level_arcs"].shape[0] == 1 + (L - cut)
    virt = rd["arc_mask"] & done
    assert (rd["start_t"][virt] == 0).all() and (rd["end_t"][virt] == 0).all()
    assert (rd["preds"][virt] == -1).all() and rd["is_start"][virt].all()
    np.testing.assert_array_equal(rd["lm"][virt], alpha[virt])
    np.testing.assert_array_equal(rd["corr"][virt], c_alpha[virt])


def test_fast_resume_shallow_bucket_allclose():
    d, lp = _case("dag", seed=2)
    L = d["level_arcs"].shape[0]
    sess = _session(d, "cuda", resume_levels=L)
    sess.rescore(truncate_levels(d, max(1, L - 2)), lp)
    fast = sess.rescore(d, lp)
    ref = sess.rescore_from_scratch(d, lp)
    np.testing.assert_allclose(fast.logZ, ref.logZ, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fast.c_avg, ref.c_avg, rtol=RTOL, atol=ATOL)


def test_session_rejects_shrinking_lattice_and_bad_checkpoint():
    d, lp = _case("sausage")
    sess = _session(d, "levelized")
    sess.rescore(d, lp)
    with pytest.raises(ValueError, match="shrank"):
        sess.rescore(truncate_levels(d, 1), lp)
    with pytest.raises(ValueError, match="arcs"):
        sess.restore(np.ones(3, bool), np.zeros(3), np.zeros(3))
    with pytest.raises(ValueError, match="no checkpoint"):
        convert.stream_checkpoint_from_numpy(sess, None)


@pytest.mark.parametrize("backend", BACKENDS)
def test_jax_checkpoint_resumes_in_port(backend):
    d, lp = _case("dag", seed=4)
    spec = session_bucket(d)
    from repro.serving.streaming import session_bucket as jax_bucket
    jsess = JaxSession(jax_bucket(d), kappa=KAPPA, backend="pallas")
    cut = max(1, d["level_arcs"].shape[0] // 2)
    jsess.rescore(truncate_levels(d, cut), lp)
    want = jsess.rescore_from_scratch(d, lp)
    sess = StreamSession(spec, kappa=KAPPA, backend=backend, device="cpu")
    convert.stream_checkpoint_from_numpy(sess, jsess.checkpoint)
    got = sess.rescore(d, lp)
    np.testing.assert_allclose(got.logZ, want.logZ, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.c_avg, want.c_avg, rtol=RTOL, atol=ATOL)
    done, alpha, _ = sess.checkpoint
    assert done.sum() == d["arc_mask"].sum()
    assert np.isfinite(alpha[done]).all()


def test_lattice_from_numpy_dict_and_batched():
    d, _ = _case("max_fanin")
    lat = convert.lattice_from_numpy(d, device="cpu")
    assert lat.start_t.shape == (1, d["start_t"].shape[0])
    assert lat.start_t.dtype == torch.int32 and lat.lm.dtype == torch.float32
    assert lat.arc_mask.dtype == torch.bool
    no_levels = {k: v for k, v in d.items() if k != "level_arcs"}
    again = convert.lattice_from_numpy(no_levels, device="cpu")
    np.testing.assert_array_equal(again.level_arcs[0].numpy(),
                                  levelize_arcs(d["preds"], d["is_start"],
                                                d["arc_mask"]))
    batched = convert.lattice_from_numpy(
        {f: getattr(lat, f).numpy() for f in lat._fields}, device="cpu")
    for f in lat._fields:
        assert torch.equal(getattr(batched, f), getattr(lat, f))


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_never_runs_the_backward_recursion(backend, monkeypatch):
    """The session's dispatch is the forward recursion alone (one
    ``dag_forward`` on the card): reaching a backward recursion of either
    backend fails the test."""
    from repro_torch.lattice_engine import cuda_backend, levelized

    def refuse(*_a, **_k):
        raise AssertionError("the streaming session ran the backward "
                             "recursion / full statistics")

    for mod, name in ((cuda_backend, "dag_backward"),
                      (cuda_backend, "sausage_backward"),
                      (levelized, "_backward_levels")):
        monkeypatch.setattr(mod, name, refuse)
    d, lp = _case("dag", seed=5)
    sess = _session(d, backend)
    cut = max(1, d["level_arcs"].shape[0] // 2)
    sess.rescore(truncate_levels(d, cut), lp)
    _assert_bits(sess.rescore(d, lp), sess.rescore_from_scratch(d, lp))


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_only_alpha_is_the_full_statistics_alpha(backend):
    from repro_torch.lattice_engine import lattice_forward, lattice_stats
    d, lp = _case("dag", seed=6)
    lat = convert.lattice_from_numpy(d, device="cpu")
    lpt = torch.from_numpy(lp)[None]
    alpha, c_alpha = lattice_forward(lat, lpt, KAPPA, backend=backend)
    full = lattice_stats(lat, lpt, KAPPA, backend=backend, topology="dag")
    assert torch.equal(alpha, full.alpha)
    assert torch.equal(c_alpha, full.c_alpha)
