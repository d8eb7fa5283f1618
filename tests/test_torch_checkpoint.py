"""The port's checkpoints (``repro_torch.checkpoint.io``) against the
reference's format, on the CPU.

  * A round trip of a nested tree (f32, a 0-d int32, bf16, a list, an
    empty dict) is bitwise and keeps dtype and device; missing keys raise
    ``ValueError``; a failed save leaves neither a temp dir nor a
    half-written target (and keeps an earlier checkpoint).
  * Across packages, both directions, for the Adam and the NGHF train
    state (``warm_start``, ``adapt_lam``, ``fisher_diag``): the reference's
    ``save_train_state`` loads in the port and the port's loads in the
    reference, every leaf equal; parameters go through
    ``convert.acoustic_params_from_numpy``.  Every leaf holds seeded
    random values, so an exchange of two leaves would show.
  * The reference's legacy params-only checkpoint loads with fresh
    optimiser state; a checkpoint of other optimiser flags raises the
    reference's message.
  * bf16 leaves: the port writes the reference's 2-byte ``|V2`` records
    byte for byte and reads the reference's back (the reference's own
    loader cannot: ROADMAP §3).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.acoustic import LSTM  # noqa: E402
from repro.core import optim as joptim  # noqa: E402
from repro.losses.sequence import MPELoss  # noqa: E402
from repro.models import acoustic as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs.acoustic import LSTM as TLSTM  # noqa: E402
from repro_torch.launch.steps import build_sequence_step  # noqa: E402

CFG, TCFG = LSTM.smoke(), TLSTM.smoke()
OPTIMIZERS = {
    "adam": {},
    "nghf": dict(warm_start=True, adapt_lam=True,
                 preconditioner="fisher_diag"),
}


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"rec0.w": torch.randn(3, 4, generator=gen),
                       "out.b": torch.randn(5, generator=gen)},
            "opt_state": {"step": torch.tensor(7, dtype=torch.int32),
                          "half": torch.randn(6, generator=gen).to(
                              torch.bfloat16),
                          "hist": [torch.randn(2, generator=gen)],
                          "precond": {}}}


def _assert_same(got, want):
    assert got.dtype == want.dtype and got.device == want.device
    assert got.shape == want.shape
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want)


def test_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    ck = str(tmp_path / "ck")
    tio.save_checkpoint(ck, tree, step=3, extra={"note": "x"})
    manifest = tio.read_manifest(ck)
    assert manifest["step"] == 3 and manifest["extra"] == {"note": "x"}
    assert manifest["keys"] == sorted(
        ["params/rec0/w", "params/out/b", "opt_state/step",
         "opt_state/half", "opt_state/hist/0"])
    with np.load(os.path.join(ck, "arrays.npz")) as z:
        assert z["opt_state/half"].dtype.str == "|V2"
        assert z["opt_state/step"].shape == ()
    got, step = tio.load_checkpoint(ck, tree)
    assert step == 3 and got["opt_state"]["precond"] == {}
    assert isinstance(got["opt_state"]["hist"], list)
    for k in ("rec0.w", "out.b"):
        _assert_same(got["params"][k], tree["params"][k])
    for k in ("step", "half"):
        _assert_same(got["opt_state"][k], tree["opt_state"][k])
    _assert_same(got["opt_state"]["hist"][0], tree["opt_state"]["hist"][0])


def test_load_takes_the_like_dtype(tmp_path):
    tree = _tree()
    ck = str(tmp_path / "ck")
    tio.save_checkpoint(ck, tree)
    like = {"params": {k: v.to(torch.float64)
                       for k, v in tree["params"].items()}}
    got, _ = tio.load_checkpoint(ck, like)
    for k, v in got["params"].items():
        assert v.dtype == torch.float64
        assert torch.equal(v, tree["params"][k].to(torch.float64))


def test_missing_keys_raise_value_error(tmp_path):
    tree = _tree()
    ck = str(tmp_path / "ck")
    tio.save_checkpoint(ck, tree)
    like = dict(tree, extra={"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="missing keys"):
        tio.load_checkpoint(ck, like)


@pytest.mark.parametrize("earlier", [False, True])
def test_failed_save_leaves_no_partial_state(tmp_path, monkeypatch,
                                             earlier):
    tree = _tree()
    ck = str(tmp_path / "ck")
    if earlier:
        tio.save_checkpoint(ck, tree, step=1)

    def broken_savez(path, **arrays):
        with open(path, "wb") as f:
            f.write(b"half")
        raise OSError("disk full")

    monkeypatch.setattr(tio.np, "savez", broken_savez)
    with pytest.raises(OSError, match="disk full"):
        tio.save_checkpoint(ck, tree, step=2)
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path)) == (["ck"] if earlier else [])
    if earlier:
        got, step = tio.load_checkpoint(ck, tree)
        assert step == 1
        _assert_same(got["params"]["rec0.w"], tree["params"]["rec0.w"])


def test_shardings_raise_not_implemented(tmp_path):
    """``shardings`` place each loaded leaf by its ``NamedSharding`` (a
    replicated one: the leaf as read, on the mesh's device); anything
    else is refused with ``TypeError``.  A split leaf's save gathers it
    over the mesh's process group (``tests/test_torch_fsdp.py`` holds
    the gathered file against a one-process save); without a running
    group it raises."""
    from types import SimpleNamespace
    from repro_torch.launch.sharding import P, NamedSharding
    ck = str(tmp_path / "ck")
    tree = _tree()
    tio.save_checkpoint(ck, tree)
    with pytest.raises(TypeError, match="NamedSharding"):
        tio.load_checkpoint(ck, _tree(), shardings=object())
    with pytest.raises(TypeError, match="NamedSharding"):
        tio.load_train_state(ck, {}, {}, shardings=object())
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 1},
                           device=torch.device("cpu"))
    rep = {"params": {k: NamedSharding(mesh, P()) for k in
                      tree["params"]}}
    got, _ = tio.load_checkpoint(ck, _tree(), shardings=rep)
    for part in ("params", "opt_state"):
        for k in ("rec0.w", "out.b", "step", "half"):
            if k in tree[part]:
                _assert_same(got[part][k], tree[part][k])
    split = {"params": {"rec0.w": NamedSharding(mesh, P("data", None))}}
    with pytest.raises(RuntimeError, match="process group"):
        tio.save_checkpoint(ck, tree, shardings=split)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _fwd(p, b):
    return JA.forward(CFG, p, b["feats"]), 0.0


def _randomize_jax(tree, seed):
    rng = np.random.default_rng(seed)

    def fill(leaf):
        a = np.asarray(leaf)
        if a.dtype.kind in "iu":
            return jnp.asarray(rng.integers(1, 100, size=a.shape), a.dtype)
        return jnp.asarray(rng.normal(size=a.shape), a.dtype)
    return jax.tree.map(fill, tree)


def _randomize_torch(tree, seed):
    gen = torch.Generator().manual_seed(seed)
    if isinstance(tree, dict):
        return {k: _randomize_torch(v, seed + i)
                for i, (k, v) in enumerate(tree.items())}
    if tree.dtype.is_floating_point:
        return torch.randn(tree.shape, generator=gen).to(tree.dtype)
    return torch.randint(1, 100, tree.shape, generator=gen,
                         dtype=tree.dtype)


def _jax_state(name):
    jp = JA.init_params(CFG, jax.random.PRNGKey(2))
    jopt = joptim.get_optimizer(name, _fwd, MPELoss(kappa=0.5),
                                **OPTIMIZERS[name])
    return _randomize_jax(jp, 1), _randomize_jax(jopt.init(jp), 2)


def _torch_state(name):
    tp = convert.acoustic_params_from_numpy(
        jax.tree.map(np.asarray, JA.init_params(CFG, jax.random.PRNGKey(2))),
        device="cpu")
    _, opt = build_sequence_step(TCFG, name, loss="mpe", kappa=0.5,
                                 **OPTIMIZERS[name])
    return tp, opt.init(tp)


def _jax_flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in jio._flatten(tree).items()}


def _torch_flat(tree) -> dict:
    return {k: v.numpy() for k, v in tio._flatten(tree).items()}


def _assert_flat_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_reference_checkpoint_loads_in_the_port(tmp_path, name):
    jp, jstate = _jax_state(name)
    ck = str(tmp_path / "ck")
    jio.save_train_state(ck, jp, jstate, step=5)
    tp_like, tstate_like = _torch_state(name)
    tp, tstate, step = tio.load_train_state(ck, tp_like, tstate_like)
    assert step == 5
    _assert_flat_equal(_torch_flat({"params": tp, "opt_state": tstate}),
                       _jax_flat({"params": jp, "opt_state": jstate}))
    # the parameters as the converter carries them across
    conv = convert.acoustic_params_from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu")
    for k, v in conv.items():
        assert torch.equal(tp[k], v)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_port_checkpoint_loads_in_the_reference(tmp_path, name):
    tp_like, tstate_like = _torch_state(name)
    tp = _randomize_torch(tp_like, 10)
    tstate = _randomize_torch(tstate_like, 20)
    ck = str(tmp_path / "ck")
    tio.save_train_state(ck, tp, tstate, step=4)
    jp_like, jstate_like = _jax_state(name)
    jp, jstate, step = jio.load_train_state(ck, jp_like, jstate_like)
    assert step == 4
    _assert_flat_equal(_jax_flat({"params": jp, "opt_state": jstate}),
                       _torch_flat({"params": tp, "opt_state": tstate}))


def test_reference_params_only_checkpoint_starts_fresh(tmp_path):
    jp, _ = _jax_state("adam")
    ck = str(tmp_path / "ck")
    jio.save_checkpoint(ck, jp, step=9)
    tp_like, tstate_like = _torch_state("adam")
    tp, tstate, step = tio.load_train_state(ck, tp_like, tstate_like)
    assert step == 9 and tstate is tstate_like
    _assert_flat_equal(_torch_flat(tp), _jax_flat(jp))


def test_other_optimizer_flags_raise_the_reference_message(tmp_path):
    tp, tstate = _torch_state("adam")
    ck = str(tmp_path / "ck")
    tio.save_train_state(ck, tp, tstate)
    tp2, nghf_state = _torch_state("nghf")
    with pytest.raises(ValueError, match="--warm-start"):
        tio.load_train_state(ck, tp2, nghf_state)


def test_bf16_records_match_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(4, 5)).astype(np.float32)
    jtree = {"h": jnp.asarray(vals, jnp.bfloat16),
             "s": jnp.asarray(2, jnp.int32)}
    ttree = {"h": torch.from_numpy(vals).to(torch.bfloat16),
             "s": torch.tensor(2, dtype=torch.int32)}
    jck, tck = str(tmp_path / "j"), str(tmp_path / "t")
    jio.save_checkpoint(jck, jtree)
    tio.save_checkpoint(tck, ttree)
    with np.load(os.path.join(jck, "arrays.npz")) as zj, \
            np.load(os.path.join(tck, "arrays.npz")) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype.str == zt[k].dtype.str
            assert zj[k].tobytes() == zt[k].tobytes()
    got, _ = tio.load_checkpoint(jck, ttree)
    _assert_same(got["h"], ttree["h"])
    # the reference's own loader cannot cast the |V2 records back
    with pytest.raises(ValueError, match="No cast function"):
        jio.load_checkpoint(jck, jtree)
