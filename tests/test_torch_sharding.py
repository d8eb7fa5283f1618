"""Port parity: the sharding rules, the batch split, the per-leaf fused
CG update and the mesh refusals (no process group needed).

``launch.sharding``'s rules take any object with ``axis_names`` and
``shape``, so they are held against ``repro.launch.sharding``'s on
shape-only stand-ins of the meshes 1x1, 4x2, 2x4, 16x16 and 2x16x16:
``param_pspec`` for every leaf of every arch of the port's registry at
full size (by shape), ``lattice_pspec``, ``batch_pspec`` (divisibility
guards included), ``sequence_input_shardings`` and ``input_shardings``
for every applicable input shape.  The reference wraps each spec in a
``NamedSharding``, which needs real devices, so its ``NamedSharding`` is
replaced by the bare spec here; and a ``PartitionSpec`` folds a one-name
tuple to the bare name, so both sides' specs are compared after folding
``(name,)`` to ``name``.  Specs must be equal.

Also: ``placements`` (spec -> ``torch.distributed.tensor`` placements),
``Optimizer.state_shardings``, ``Prefetcher``,
``data.pipeline.shard_batch`` (each rank's rows; a batch that does not
divide is kept whole), ``subsample_batch(..., multiple=)`` against the
reference's, ``cg_fused_update_tree``'s plain path against the
reference's ``cg_fused_update_tree_ref`` (x, r within one rounding, rr
rtol 1e-6: the port folds the partials in double), ``cg_solve``'s
per-leaf fused path against its flat one (rtol 1e-5), and the refusals:
a mesh larger than the run (the LM trainer's too, which trains on a mesh
since ROADMAP 1.4 part 2) and a ``"cuda"`` mesh without a card.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import INPUT_SHAPES, get_config as jget_config  # noqa: E402,E501
from repro.core.curvature import subsample_batch as jsubsample  # noqa: E402
from repro.data.synthetic import asr_batch as jasr_batch  # noqa: E402
from repro.kernels import ref as JR  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.launch.dryrun import applicable  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.core import cg as tcg  # noqa: E402
from repro_torch.core import tree_math as tm  # noqa: E402
from repro_torch.core.curvature import batch_size, subsample_batch  # noqa: E402,E501
from repro_torch.data.pipeline import batch_splits, shard_batch  # noqa: E402
from repro_torch.data.synthetic import asr_batch  # noqa: E402
from repro_torch.kernels import cg_fused as CG  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.launch import sharding as TS  # noqa: E402
from repro_torch.losses.lattice import Lattice  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402


def _mesh(**shape):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


MESHES = {"1x1": _mesh(data=1, model=1), "4x2": _mesh(data=4, model=2),
          "2x4": _mesh(data=2, model=4), "16x16": _mesh(data=16, model=16),
          "2x16x16": _mesh(pod=2, data=16, model=16)}


def _fold(spec) -> tuple:
    """A spec's entries, a one-name tuple folded to the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's rules returning bare specs (no devices)."""
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)


def _ref_leaves(tree) -> dict:
    """{dotted path: leaf} of a reference pytree."""
    return {".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch):
    """Every leaf of ``arch`` at full size, on every mesh: the port's
    ``param_pspec`` (and ``param_shardings``) give the reference's spec."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes = get_model(cfg).param_shapes()
    jshapes = _ref_leaves(jget_model(jcfg).param_shapes())
    assert set(shapes) == set(jshapes)
    for name, mesh in MESHES.items():
        shard = TS.param_shardings(cfg, mesh, shapes)
        for key, (shape, _) in shapes.items():
            assert tuple(jshapes[key].shape) == shape, key
            want = JS.param_pspec(jcfg, mesh, key.split("."), shape)
            got = TS.param_pspec(cfg, mesh, key.split("."), shape)
            assert _fold(got) == _fold(want), (name, key, got, want)
            assert shard[key].spec == got and shard[key].mesh is mesh


def test_lattice_and_batch_specs_match_reference(bare_specs):
    """``lattice_pspec`` and ``batch_pspec`` on leading dims that divide
    the data extent, divide one data axis only, or none; and
    ``sequence_input_shardings`` of the same seeded ASR batch, field by
    field, in both packages."""
    shapes = [(), (4,), (8, 48), (16, 48), (32, 48, 3), (6, 16, 3),
              (64, 12, 5), (512, 2)]
    for name, mesh in MESHES.items():
        for shape in shapes:
            got = TS.lattice_pspec(mesh, shape)
            want = JS.lattice_pspec(mesh, shape)
            assert _fold(got) == _fold(want), (name, shape, got, want)
        for nd in (1, 2, 3):
            for divisible in (True, False):
                assert _fold(TS.batch_pspec(mesh, nd, divisible)) == _fold(
                    JS.batch_pspec(mesh, nd, divisible)), (name, nd)
        for B in (4, 6, 32):
            kw = dict(batch=B, num_frames=16, num_states=8, input_dim=6)
            got = TS.sequence_input_shardings(
                mesh, asr_batch(0, device="cpu", **kw))
            want = JS.sequence_input_shardings(mesh, jasr_batch(0, **kw))
            for k in ("feats", "labels"):
                assert _fold(got[k]) == _fold(want[k]), (name, B, k)
            for field in Lattice._fields:
                assert _fold(getattr(got["lattice"], field)) == _fold(
                    getattr(want["lattice"], field)), (name, B, field)


@pytest.mark.parametrize("arch", list_archs())
def test_input_specs_match_reference(arch, bare_specs):
    """``input_shardings`` for every applicable input shape of ``arch``
    (tokens, labels, encoder inputs, every decode cache leaf), on every
    mesh."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    model, jmodel = get_model(cfg), jget_model(jcfg)
    for shape_name in INPUT_SHAPES:
        if not applicable(jcfg, shape_name):
            continue
        specs = model.input_specs(shape_name)
        jspecs = jmodel.input_specs(shape_name)
        for name, mesh in MESHES.items():
            got = TS.input_shardings(cfg, mesh, specs)
            want = _ref_leaves(JS.input_shardings(jcfg, mesh, jspecs))
            flat = {k: v for k, v in got.items() if k != "cache"}
            flat.update({"cache." + k: v
                         for k, v in got.get("cache", {}).items()})
            assert set(flat) == set(want), (shape_name, name)
            for key, spec in flat.items():
                assert _fold(spec) == _fold(want[key]), (shape_name, name,
                                                         key)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    pod = MESHES["2x16x16"]
    assert TS.placements(pod, TS.P(("pod", "data"), None, "model"), 3) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.placements(pod, TS.P(), 2) == (Replicate(),) * 3
    mesh = MESHES["4x2"]
    assert TS.placements(mesh, TS.P(None, "data"), 2) == (Shard(1),
                                                          Replicate())
    assert TS.placements(mesh, TS.P("model", None), 2) == (Replicate(),
                                                           Shard(0))


def test_shard_batch_gives_each_rank_its_rows():
    """Each data rank's share is its contiguous block of rows of every
    batch-leading tensor, Lattice fields included, and the shares make
    the whole; a batch that does not divide the data extent is kept
    whole."""
    b = asr_batch(0, batch=8, num_frames=16, num_states=8, input_dim=6,
                  device="cpu")
    shares = []
    for i in range(4):
        mesh = SimpleNamespace(axis_names=("data", "model"),
                               shape={"data": 4, "model": 2},
                               data_extent=4, data_index=i)
        assert batch_splits(b, mesh)
        shares.append(shard_batch(b, mesh))
        assert batch_size(shares[-1]) == 2
    for k in ("feats", "labels"):
        assert torch.equal(torch.cat([s[k] for s in shares]), b[k])
    for field in Lattice._fields:
        assert torch.equal(torch.cat([getattr(s["lattice"], field)
                                      for s in shares]),
                           getattr(b["lattice"], field)), field
    odd = asr_batch(0, batch=6, num_frames=16, num_states=8, input_dim=6,
                    device="cpu")
    assert not batch_splits(odd, mesh) and shard_batch(odd, mesh) is odd


@pytest.mark.parametrize("B,frac,multiple", [
    (8, 0.5, 1), (8, 0.5, 4), (8, 0.3, 4), (8, 0.3, 2), (6, 0.5, 4),
    (4, 0.5, 4), (12, 0.25, 8), (32, 0.1, 4)])
def test_subsample_rounds_to_the_data_extent(B, frac, multiple):
    kw = dict(batch=B, num_frames=8, num_states=5, input_dim=3)
    got = subsample_batch(asr_batch(1, device="cpu", **kw), frac,
                          multiple=multiple)
    want = jsubsample(jasr_batch(1, **kw), frac, multiple=multiple)
    assert batch_size(got) == want["feats"].shape[0]
    np.testing.assert_array_equal(got["feats"].numpy(),
                                  np.asarray(want["feats"]))


def _leaves(rng):
    shapes = {"rec0.w": (6, 5), "rec0.b": (5,), "out.w": (70001,),
              "out.b": (3,)}
    return [{k: rng.normal(size=s).astype(np.float32) for k, s in
             shapes.items()} for _ in range(4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cg_fused_update_tree_matches_reference(dtype):
    """The per-leaf update on CPU tensors (the plain version, leaf by
    leaf) against the reference's ``cg_fused_update_tree_ref``; rr the
    double fold of the per-leaf partials."""
    rng = np.random.default_rng(5)
    trees = _leaves(rng)
    td, jd = getattr(torch, dtype), jnp.dtype(dtype)
    tx = [{k: torch.from_numpy(v).to(td) for k, v in t.items()}
          for t in trees]
    jx = [{k: jnp.asarray(v).astype(jd) for k, v in t.items()}
          for t in trees]
    alpha = np.float32(0.43)
    got = CG.cg_fused_update_tree(torch.tensor(alpha), *tx)
    want = JR.cg_fused_update_tree_ref(jnp.float32(alpha), *jx)
    tol = 0.0 if dtype == "float32" else 2.0 ** -8
    for g, w in zip(got[:2], want[:2]):
        assert list(g) == list(tx[0])
        for k in g:
            assert g[k].dtype == td and g[k].shape == tx[0][k].shape
            np.testing.assert_allclose(
                g[k].float().numpy(), np.asarray(w[k].astype(jnp.float32)),
                rtol=tol, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
    plain = R.cg_fused_update_tree_ref(torch.tensor(alpha), *tx)
    for g, p in zip(got, plain):
        assert all(torch.equal(g[k], p[k]) for k in g) \
            if isinstance(g, dict) else torch.equal(g, p)


def test_cg_solve_per_leaf_path_matches_flat_path():
    """``cg_solve(fused=True, constrain=Layout)`` runs the per-leaf
    update and lands where the flat-buffer path does; a vector that does
    not fit the layout raises."""
    rng = np.random.default_rng(6)
    shapes = {"a.w": (4, 3), "a.b": (3,), "z": (5,)}
    n = sum(int(np.prod(s)) for s in shapes.values())
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    mat = torch.from_numpy(((q * np.linspace(0.5, 6.0, n)) @ q.T)
                           .astype(np.float32))
    b = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
         for k, s in shapes.items()}

    def bv(v):
        flat, unravel = tm.ravel(v)
        return unravel(mat @ flat)

    layout = tm.Layout({k: tuple(s) for k, s in shapes.items()}, {})
    flat = tcg.cg_solve(bv, b, iters=6, fused=True, eval_fn=lambda x: tm.
                        vdot(x, x))
    tree = tcg.cg_solve(bv, b, iters=6, fused=True, eval_fn=lambda x: tm.
                        vdot(x, x), constrain=layout)
    assert int(tree.best_iter) == int(flat.best_iter)
    for k in shapes:
        np.testing.assert_allclose(tree.x[k].numpy(), flat.x[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tree.resid.numpy(), flat.resid.numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="layout"):
        tcg.cg_solve(bv, b, iters=2, fused=True, constrain=layout,
                     x0={k: torch.zeros(2) for k in shapes})


def test_state_shardings_mirror_the_state():
    """``Optimizer.state_shardings`` gives every leaf of ``init``'s state
    its sharding: theta-sized slots their parameter's, scalars replicated
    on the same mesh; ``init`` refuses a sharding of other keys."""
    from repro_torch.configs.acoustic import LSTM as TLSTM
    from repro_torch.launch.steps import build_sequence_step
    from repro_torch.models import acoustic
    cfg = TLSTM.smoke()
    params = acoustic.init_params(cfg, 0, device="cpu")
    mesh = MESHES["4x2"]
    ss = TS.replicated_shardings(mesh, params)
    _, opt = build_sequence_step(cfg, "nghf", state_sharding=ss,
                                 warm_start=True,
                                 preconditioner="fisher_diag")
    state = opt.init(params, state_sharding=ss)
    shard = opt.state_shardings(ss)
    assert set(shard) == set(state) == {"step", "lam", "precond", "delta"}
    assert shard["delta"] is ss and shard["precond"]["d"] is ss
    for s in (shard["step"], shard["lam"], shard["precond"]["n"]):
        assert s.mesh is mesh and s.spec == TS.P()
    with pytest.raises(ValueError, match="does not match"):
        opt.init(params, state_sharding={"rec0.w": ss["rec0.w"]})


def test_prefetcher_yields_batches_in_order():
    from repro_torch.data.pipeline import Prefetcher
    pre = Prefetcher(lambda seed: {"seed": seed}, depth=2, num_batches=5)
    assert [b["seed"] for b in pre] == [0, 1, 2, 3, 4]
    pre.close()


def test_meshes_refuse_what_the_run_cannot_hold():
    """No fallback: a mesh of more ranks than the run has raises, before
    any process group starts, for the LM trainer too (it trains on a mesh
    since ROADMAP 1.4 part 2: ``tests/test_torch_mesh_lm.py``); so does a
    card mesh without a card."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    from repro_torch.launch.train import resolve_mesh, train_lm
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        M.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        M.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs 8 ranks"):
        resolve_mesh("4x2", "cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="mesh="):
        resolve_mesh("four", "cpu")
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        train_lm(arch="qwen2.5-3b", smoke=True, steps=1, device="cpu",
                 mesh="2x1")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            M.make_debug_mesh(1, 1, device="cuda")
