"""Port parity: LM training of the dense archs through
``launch.steps.build_step`` and the training CLI, on qwen2.5-3b's smoke
config (tied embeddings, q/k/v biases, GQA 4/2) and stablelm-1.6b's
(LayerNorm, partial rotary, untied), at f32 compute, on the CPU.

  * One NGHF update (4 CG, 2 NG iterations, the share-counts
    preconditioner, ``cg_frac=4``), fused and unfused CG, from the same
    parameters (the reference's tree, its vector leaves perturbed, carried
    across by ``convert.lm_params_from_numpy``) and the same
    ``lm_batch``: the same ``cg_best_iter``, ``cg_accepted`` and
    ``cg_iters_used``; candidate losses within 1e-4 relative; Δθ within
    relative L2 1e-4 (f32 on both sides, sums in other orders carried
    through 6 curvature products).  With tied embeddings the head is the
    table transposed, so the table's tangent and cotangent carry both
    the gather's and the head's parts.
  * ``share_counts``: the tied table counts 2, every other leaf 1, as the
    reference's.
  * The CLI's default arch, qwen2.5-3b, trains 2 steps at smoke size.
  * A tied train state (no ``embed.lm_head``) saved by the port loads in
    the reference, and the reference's in the port, leaf for leaf.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch.steps import build_step as jbuild  # noqa: E402
from repro.launch.steps import cg_sub_batch as jsub  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import base as TCB  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_step, cg_sub_batch  # noqa: E402
from repro_torch.models.registry import get_model as tmodel  # noqa: E402
from torch_perturb import perturb  # noqa: E402

B, T = 8, 32
DELTA_REL_L2 = 1e-4
LOSS_RTOL = 1e-4
EXACT = ("cg_best_iter", "cg_accepted", "cg_iters_used")
NGHF = dict(cg_iters=4, ng_iters=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return (jget(arch).smoke().replace(compute_dtype="float32"),
            TCB.get_config(arch).smoke().replace(compute_dtype="float32"))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."):
            np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _delta_rel_l2(new_t, tp, new_j, jp) -> float:
    nj, pj = _flat(new_j), _flat(jp)
    num = den = 0.0
    for k, p in tp.items():
        dj = nj[k] - pj[k]
        num += float((((new_t[k] - p).numpy() - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    return (num / max(den, 1e-30)) ** 0.5


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "stablelm-1.6b"])
def test_nghf_update_matches_the_reference(arch, fused):
    jcfg, tcfg = _cfgs(arch)
    jp = perturb(jmodel(jcfg).init(jax.random.PRNGKey(0)), 1)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    assert ("embed.lm_head" in tp) == (not jcfg.tie_embeddings)
    jb = jbatch(0, batch=B, seq_len=T, vocab=jcfg.vocab_size)
    tb = lm_batch(0, batch=B, seq_len=T, vocab=tcfg.vocab_size, device="cpu")
    _, jopt = jbuild(jcfg, "nghf", cg_frac=4, cg_fused=fused, **NGHF)
    step, topt = build_step(tcfg, "nghf", cg_frac=4, cg_fused=fused, **NGHF)
    jb = dict(jb, labels=jb["tokens"])
    tb = dict(tb, labels=tb["tokens"])
    new_j, _, mj = jax.jit(lambda p: jopt.step(p, jopt.init(p), jb,
                                               jsub(jb, 4, 1)))(jp)
    new_t, st, mt = topt.step(tp, topt.init(tp), tb, cg_sub_batch(tb, 4, 1))
    assert int(st["step"]) == 1
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    for key in EXACT:
        assert float(mt[key]) == float(mj[key]), key
    np.testing.assert_allclose(mt["cg_losses"].numpy(),
                               np.asarray(mj["cg_losses"]), rtol=LOSS_RTOL)
    assert bool(mt["cg_accepted"]) == bool(
        mt["cg_best_loss"] < mt["cg_base_loss"])
    assert _delta_rel_l2(new_t, tp, new_j, jp) <= DELTA_REL_L2
    # the table moved (through both its uses when tied)
    assert not torch.equal(new_t["embed.table"], tp["embed.table"]) \
        or not bool(mt["cg_accepted"])


def test_share_counts_of_the_tied_table_match_the_reference():
    for arch in ("qwen2.5-3b", "stablelm-1.6b"):
        jcfg, tcfg = _cfgs(arch)
        jm = jmodel(jcfg)
        want = _flat(jm.share_counts(jm.param_shapes()))
        tm = tmodel(tcfg)
        got = tm.share_counts(tm.param_shapes())
        assert got == {k: float(v) for k, v in want.items()}
        assert got["embed.table"] == (2.0 if jcfg.tie_embeddings else 1.0)
    full = tmodel(TCB.get_config("qwen2.5-3b"))
    counts = full.share_counts(full.param_shapes())
    assert {k for k, c in counts.items() if c != 1.0} == {"embed.table"}
    assert counts["embed.table"] == 2.0


def test_cli_default_arch_trains_at_smoke_size():
    log = ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                       "--batch", "4", "--seq", "16", "--cg-iters", "3",
                       "--ng-iters", "1", "--cg-fused"])
    assert [m["step"] for m in log] == [0, 1]
    assert all(np.isfinite(v) for m in log for v in m.values())
    for m in log:
        if m["cg_accepted"]:
            assert m["cg_best_loss"] < m["cg_base_loss"]


def _npz(ck) -> dict:
    with np.load(f"{ck}/arrays.npz") as z:
        return {k: z[k] for k in z.files}


def test_tied_train_states_load_across_packages(tmp_path):
    """NGHF's train state of qwen2.5-3b's smoke model (tied: no
    ``embed.lm_head``): the port's CLI checkpoint loads in the reference,
    which saves it again with the same keys and arrays; that file loads
    back in the port as the state it saved."""
    ck, jck = str(tmp_path / "port"), str(tmp_path / "ref")
    ttrain.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
                 "--steps", "1", "--batch", "4", "--seq", "16",
                 "--cg-iters", "2", "--ng-iters", "1", "--ckpt-dir", ck])
    tcfg = TCB.get_config("qwen2.5-3b").smoke()
    like = tmodel(tcfg).init(0, device="cpu")
    _, topt = build_step(tcfg, "nghf")
    tparams, tstate, step = tio.load_train_state(ck, like, topt.init(like))
    assert step == 1 and "embed.lm_head" not in tparams
    jcfg = jget("qwen2.5-3b").smoke()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(1))
    assert "lm_head" not in jp["embed"]
    _, jopt = jbuild(jcfg, "nghf")
    got_p, got_s, jstep = jio.load_train_state(ck, jp, jopt.init(jp))
    assert jstep == 1
    for k, v in _flat(got_p).items():
        np.testing.assert_array_equal(v, tparams[k].numpy())
    jio.save_train_state(jck, got_p, got_s, step=1)
    mine, theirs = _npz(ck), _npz(jck)
    assert mine.keys() == theirs.keys()
    assert any(k.startswith("opt_state") for k in mine)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])
    p2, s2, n = tio.load_train_state(jck, like, topt.init(like))
    assert n == 1
    a, b = tio._flatten({"p": p2, "s": s2}), tio._flatten(
        {"p": tparams, "s": tstate})
    assert a.keys() == b.keys()
    assert all(torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
               for k in a)
