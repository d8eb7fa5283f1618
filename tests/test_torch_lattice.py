"""Port parity: lattice builders, batching and frontier tensors.

The numpy builders of ``repro_torch.losses.lattice`` must draw from the
generator in the reference's order (identical arrays from one seed), and
``lattice_frontiers`` is pure integer/boolean work, so both are held to
EXACT equality with the JAX package — no tolerance.
"""
import jax
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis import corpus as jcorpus  # noqa: E402
from repro.losses import lattice as JL  # noqa: E402
from repro_torch.analysis import corpus as tcorpus  # noqa: E402
from repro_torch.losses import lattice as TL  # noqa: E402

K = 6

# one compiled executable per shape instead of eager per-op dispatch
_jax_frontiers = jax.jit(JL.lattice_frontiers,
                         static_argnames=("max_levels", "max_width"))

BUILDERS = {
    "sausage": lambda m, rng: m.make_sausage_lattice(
        rng, num_frames=16, num_states=K, seg_len=4, n_alt=3),
    "sausage_ragged": lambda m, rng: m.make_sausage_lattice(
        rng, num_frames=14, num_states=K, seg_len=4, n_alt=2, max_arcs=12),
    "dag": lambda m, rng: m.make_random_dag_lattice(
        rng, num_frames=16, num_states=K, max_arcs=90),
    "dag_skipless": lambda m, rng: m.make_random_dag_lattice(
        rng, num_frames=12, num_states=K, skip_prob=0.0, max_arcs=60),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _dicts(module, name, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [BUILDERS[name](module, rng) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_identical_arrays(name):
    for dj, dt in zip(_dicts(JL, name), _dicts(TL, name)):
        assert dj.keys() == dt.keys()
        for k in dj:
            _same(dj[k], dt[k])


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_batch_lattices_and_frame_counts(name):
    jl = JL.batch_lattices(_dicts(JL, name))
    tl = TL.batch_lattices(_dicts(TL, name), device="cpu")
    for f in TL.Lattice._fields:
        _same(getattr(jl, f), getattr(tl, f).numpy())
    _same(JL.lattice_frame_counts(jl), TL.lattice_frame_counts(tl).numpy())
    _same(JL.lattice_frame_mask(jl), TL.lattice_frame_mask(tl).numpy())
    assert (tl.num_arcs, tl.num_frames, tl.num_levels) == \
        (jl.num_arcs, jl.num_frames, jl.num_levels)


@pytest.mark.parametrize("pad", [(0, 0), (2, 3)])
@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_frontiers_integer_identical(name, pad):
    jl = JL.batch_lattices(_dicts(JL, name))
    tl = TL.batch_lattices(_dicts(TL, name), device="cpu")
    L, W = jl.level_arcs.shape[1:]
    kw = {} if pad == (0, 0) else dict(max_levels=L + pad[0],
                                       max_width=W + pad[1])
    fj = _jax_frontiers(jl, **kw)
    ft = TL.lattice_frontiers(tl, **kw)
    for f in TL.Frontiers._fields:
        _same(getattr(fj, f), getattr(ft, f).numpy())


@pytest.mark.parametrize("case", sorted(tcorpus.ADVERSARIAL_CASES))
def test_corpus_cases_identical(case):
    jl, jt, jk = jcorpus.ADVERSARIAL_CASES[case](0)
    tl, tt, tk = tcorpus.ADVERSARIAL_CASES[case](0, device="cpu")
    assert (jt, jk) == (tt, tk)
    for f in TL.Lattice._fields:
        _same(getattr(jl, f), getattr(tl, f).numpy())
    fj, ft = _jax_frontiers(jl), TL.lattice_frontiers(tl)
    for f in TL.Frontiers._fields:
        _same(getattr(fj, f), getattr(ft, f).numpy())


def test_make_lattice_batch_identical():
    jl = JL.make_lattice_batch(3, batch=2, num_frames=12, num_states=K)
    tl = TL.make_lattice_batch(3, batch=2, num_frames=12, num_states=K,
                               device="cpu")
    for f in TL.Lattice._fields:
        _same(getattr(jl, f), getattr(tl, f).numpy())


def test_frontiers_errors():
    tl = TL.batch_lattices(_dicts(TL, "sausage"), device="cpu")
    with pytest.raises(ValueError, match="padding only"):
        TL.lattice_frontiers(tl, max_levels=1)
    with pytest.raises(ValueError, match="batch_lattices"):
        TL.lattice_frontiers(tl._replace(level_arcs=None))


def test_levelize_rejects_unsorted_arcs():
    preds = np.array([[1], [-1]], np.int32)
    with pytest.raises(ValueError, match="topologically sorted"):
        TL.levelize_arcs(preds, np.array([False, True]),
                         np.array([True, True]))


def test_acoustic_configs_match_reference():
    from repro.configs import acoustic as jcfg
    from repro_torch.configs import acoustic as tcfg
    assert tcfg.ASR_ARCHS == jcfg.ASR_ARCHS
    assert sorted(tcfg.ACOUSTIC_CONFIGS) == sorted(jcfg.ACOUSTIC_CONFIGS)
    for name, cfg in tcfg.ACOUSTIC_CONFIGS.items():
        ref = jcfg.ACOUSTIC_CONFIGS[name]
        assert vars(cfg) == vars(ref)
        assert vars(cfg.smoke()) == vars(ref.smoke())
    assert tcfg.get_acoustic_config("lstm-asr").num_outputs == 6000
    with pytest.raises(ValueError, match="unknown acoustic arch"):
        tcfg.get_acoustic_config("gpt")
