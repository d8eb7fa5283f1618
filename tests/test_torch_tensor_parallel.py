"""Port parity: tensor-parallel compute over "model" on its own
(``launch.tensor_parallel``, ``launch.sharding.compute_pspec``, the
vocab-parallel ``losses.chunked_lm``).

On gloo meshes of 2 and 4 CPU ranks (1x2, 2x2 and 1x4; a process a rank,
one thread each, ``tests/torch_mesh_lm_worker.py::tp_units``):

  * Megatron's f (``copy_to_model``) and g (``reduce_from_model``) around
    a toy with a column-parallel matrix, a row-parallel one and a leaf
    used whole inside the split region: the forward, ``torch.func.jvp``
    and ``linearize`` within 1e-6 of the whole toy's and ``torch.func.
    vjp`` and autograd giving each rank its share of the whole gradient
    within 1e-6 (the largest difference over the largest entry); the
    same of ``gather_from_model`` between two column-parallel matrices,
    the second reading all of the first's output;
  * the vocab-parallel embedding: the whole table's rows and their
    gradient's share, the same bits;
  * the chunked CE on each rank's vocab columns (T in two chunks, some
    tokens' top logit tied between two ranks' columns): loss, gradient,
    GN and Fisher factors within relative max 1e-5 of the whole vocab's
    and of the reference's ``repro.losses.chunked_lm``, ``acc`` equal
    (the tie goes to the lowest index, as ``jnp.argmax``);
  * the gradients of the qwen2.5-3b smoke model with q/k norms (its 2 kv
    heads whole on each rank of 1x4), granite-moe-3b-a800m's (4 experts),
    granite's with 2 experts (each expert's columns split 4 ways),
    recurrentgemma-9b's (its RG-LRU blocks by channels, their MLPs by
    columns), xlstm-125m's (the mLSTM and sLSTM blocks by heads),
    whisper-base's (every attention, MLP, the vocab and ``dec_pos``) and
    xlstm's with 2 heads (its mLSTM and sLSTM units whole on 1x4): every
    leaf, the replicated-inside-TP ones (``wk``/``wv``/``bk``/``bv``,
    ``q_norm``/``k_norm``, ``router``, ``conv_b``, ``log_lambda``,
    ``b_if``, ``b_zifo``) among them, within 1e-5 of one process's,
    relative to the leaf's largest entry, and a GN product in both
    curvature modes (rematvp, linearize) within relative L2 1e-5;
    ``vdot``/``norm`` of the split gradient within rtol 1e-5; the
    model's ``forward`` (its split head's logits gathered whole) within
    1e-6 of one process's, relative to the largest logit, for the
    attention archs, and within 1e-5 for the recurrent and enc-dec ones,
    whose forwards sum up to six row-parallel products (each adds
    3-5e-7 of f32 rounding: recurrentgemma's read 1.1-1.3e-6); the units
    split where "model" divides the heads (xlstm's with 2 heads whole on
    1x4).  One process's results come from this process
    (``tp_one_process``).  The cases' norm scales and biases and q/k/v
    biases are perturbed off the reference's draw, and every
    decoder-only case runs with sequence-parallel activations (its
    residual stream split over T between the units;
    ``tests/test_torch_sequence_parallel.py`` holds that part on its
    own).

Without processes: ``models.layers.partial_matmul`` (a row-parallel
product of bf16 operands with an f32 result) against the f32 upcast's
product under the forward, autograd, ``torch.func.jvp`` and
``linearize``, for a matrix and for a stack of experts' matrices (the
f32 results within 1e-6 of the largest entry, the bf16 gradients within
one bf16 step, 2^-8, of it); ``compute_pspec`` against the reference's 1d
``param_pspec`` (its ``make_spec_fn``) for every leaf of every LM arch
at full size, by shape, on 1x2, 2x2 and 1x4, its "model" entries those
of the stored spec; ``tp_leaf``: the ``attn``, ``mlp`` and ``moe``
leaves of the attention-family blocks, the recurrent blocks' temporal
leaves and RG-LRU MLPs, every attention and MLP leaf of an enc-dec arch,
its ``dec_pos``, and the vocab leaves; never a norm.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_lm_worker as LW  # noqa: E402
import torch_mesh_worker as W  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.losses.chunked_lm import ChunkedCELoss as JLoss  # noqa: E402
from repro_torch.configs.base import get_config, list_archs  # noqa: E402
from repro_torch.launch import sharding as TS  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402

MESHES = {"1x2": 2, "2x2": 4, "1x4": 4}
TOY_REL = 1e-6
CE_REL = 1e-5
GRAD_REL = 1e-5
B, T, D, V, T_CHUNK = 2, 6, 8, 64, 4
TIE = 3                      # columns TIE and TIE + V // 2 are equal


def _ce_inputs() -> dict:
    """(h, W, y, uh, uW, tokens, table, ct_e): the first three tokens'
    hidden states all u, whose logit at columns TIE and TIE + V/2 (one
    rank's and another's) is 4, above every other."""
    rng = np.random.default_rng(0)
    h = rng.normal(size=(B, T, D)).astype(np.float32)
    W = (rng.normal(size=(D, V)) * 0.1).astype(np.float32)
    u = h[0, 0]
    W[:, TIE] = W[:, TIE + V // 2] = 4.0 * u / float(u @ u)
    h[0, :3] = u
    y = rng.integers(0, V, size=(B, T)).astype(np.int64)
    y[0, :2] = TIE
    return dict(h=h, W=W, y=y,
                uh=rng.normal(size=(B, T, D)).astype(np.float32),
                uW=(rng.normal(size=(D, V)) * 0.1).astype(np.float32),
                tokens=rng.integers(0, V, size=(B, T)).astype(np.int64),
                table=rng.normal(size=(V, D)).astype(np.float32),
                ct_e=rng.normal(size=(B, T, D)).astype(np.float32),
                t_chunk=np.asarray(T_CHUNK))


def _reference(x: dict) -> dict:
    """The reference's loss, acc, gradient and factors on ``x``."""
    loss = JLoss(t_chunk=T_CHUNK)
    h, Wm = jnp.asarray(x["h"]), jnp.asarray(x["W"])
    batch = {"labels": jnp.asarray(x["y"].astype(np.int32))}
    val, met = loss.value((h, Wm), batch)
    gh, gW = jax.grad(lambda a, b: loss.value((a, b), batch)[0],
                      argnums=(0, 1))(h, Wm)
    out = {"loss": val, "acc": met["acc"], "grad_h": gh, "grad_W": gW}
    u = (jnp.asarray(x["uh"]), jnp.asarray(x["uW"]))
    for kind in ("gn_vp", "fisher_vp"):
        ch, cw = getattr(loss, kind)((h, Wm), batch, u)
        out[kind + "_h"], out[kind + "_W"] = ch, cw
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    """(every rank's results by mesh, the reference's CE results); the
    meshes run at once while this process computes the reference."""
    x = _ce_inputs()
    started = {}
    for mesh, n in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"tp_{mesh}")
        np.savez(tmp / "ce_inputs.npz", **x)
        started[mesh] = W.start("torch_mesh_lm_worker:tp_units", n, tmp,
                                mesh=mesh)
    ref = _reference(x)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref["one"] = {name: LW.tp_one_process(name)
                      for name in LW.TP_GRAD_CASES}
    finally:
        torch.set_num_threads(n)
    return {m: W.finish(h) for m, h in started.items()}, ref


@pytest.fixture(params=sorted(MESHES))
def outs(request, units):
    got = units[0][request.param]
    assert len(got) == MESHES[request.param]
    return got


@pytest.mark.parametrize("what", ["forward", "jvp", "linearize", "vjp",
                                  "autograd"])
def test_f_and_g_match_one_process(outs, what):
    for o in outs:
        assert float(o["toy_" + what]) <= TOY_REL, (what, o["toy_" + what])


@pytest.mark.parametrize("what", ["forward", "jvp", "linearize", "vjp",
                                  "autograd"])
def test_gather_from_model_matches_one_process(outs, what):
    """An activation gathered whole over "model" and read by each rank's
    columns: the whole toy's forward and tangents, and each rank its
    share of the gradient (the backward's reduce-scatter)."""
    for o in outs:
        assert float(o["gtoy_" + what]) <= TOY_REL, (what, o["gtoy_" + what])


def test_vocab_parallel_embedding_is_the_whole_tables(outs):
    for o in outs:
        lo, hi = o["ce_cols"]
        assert np.array_equal(o["ce_split.emb"], o["ce_whole.emb"])
        assert np.array_equal(o["ce_split.emb_grad"],
                              o["ce_whole.emb_grad"][lo:hi])


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("what", ["loss", "grad_h", "grad_W", "gn_vp_h",
                                  "gn_vp_W", "fisher_vp_h", "fisher_vp_W"])
def test_vocab_parallel_ce_matches_whole_and_reference(units, outs, what):
    ref = units[1]
    for o in outs:
        lo, hi = o["ce_cols"]
        whole, split = o["ce_whole." + what], o["ce_split." + what]
        cut = (lambda a: a[:, lo:hi]) if what.endswith("_W") else \
            (lambda a: a)
        assert _rel(whole, ref[what]) <= CE_REL, what
        assert _rel(split, cut(whole)) <= CE_REL, what
        assert _rel(split, cut(ref[what])) <= CE_REL, what


def test_vocab_parallel_acc_breaks_ties_low(units, outs):
    """The tied tokens' argmax is column TIE (their label) on one
    process, in the reference and across ranks."""
    ref = units[1]
    for o in outs:
        assert float(o["ce_split.acc"]) == float(o["ce_whole.acc"]) \
            == float(ref["acc"])
        assert float(o["ce_whole.acc"]) >= 2 / (B * T)


def _leaf_rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# the leaves a split unit may use whole on every rank (f on their way in)
INSIDE = ("wk", "wv", "bk", "bv", "q_norm", "k_norm", "router", "conv_b",
          "log_lambda", "b_if", "b_zifo")


@pytest.mark.parametrize("name", sorted(LW.TP_GRAD_CASES))
def test_gradients_match_one_process(units, outs, name):
    """Every leaf's gradient, the replicated-inside-TP ones among them,
    as one process's; on 1x4 qwen's kv leaves are whole on every rank.
    whisper-base's smoke has none (its kv heads divide "model")."""
    cfg = LW.tp_grad_cfg(name)
    shapes = get_model(cfg).param_shapes()
    one = units[1]["one"][name]
    inside = [k for k in shapes if k.split(".")[-1] in INSIDE]
    assert inside or cfg.is_encoder_decoder
    for o in outs:
        for k in shapes:
            assert _leaf_rel(o[f"{name}/g.{k}"], one[f"g_one.{k}"]) \
                <= GRAD_REL, k
    # the kv heads (2) whole on every rank where "model" is 4 ranks
    if name == "qwen_qk" and max(int(o["model_index"]) for o in outs) == 3:
        for o in outs:
            for k in inside:
                assert tuple(o[f"{name}/share.{k}"]) == shapes[k][0], k


@pytest.mark.parametrize("name", sorted(LW.TP_GRAD_CASES))
@pytest.mark.parametrize("mode", ["rematvp", "linearize"])
def test_gn_products_match_one_process(units, outs, name, mode):
    cfg = LW.tp_grad_cfg(name)
    keys = list(get_model(cfg).param_shapes())
    one = units[1]["one"][name]
    for o in outs:
        a = np.concatenate([o[f"{name}/gv_{mode}.{k}"].ravel() for k in keys])
        b = np.concatenate([one[f"gv_one_{mode}.{k}"].ravel() for k in keys])
        assert np.linalg.norm(a - b) / np.linalg.norm(b) <= GRAD_REL
        np.testing.assert_allclose(o[f"{name}/dots"], one["dots_one"],
                                   rtol=GRAD_REL)


def _logits_rel(o, one, name) -> float:
    got = o[f"{name}/logits"]
    return float(np.abs(got - one[name]["logits_one"]).max()
                 / np.abs(got).max())


# the attention archs' cases, whose forwards hold one process's to 1e-6
ATTENTION_CASES = ("qwen_qk", "granite", "granite_e2")


def test_forward_gathers_the_split_vocab(units, outs):
    for o in outs:
        for name in ATTENTION_CASES:
            assert _logits_rel(o, units[1]["one"], name) <= 1e-6, name


@pytest.mark.parametrize("name", sorted(set(LW.TP_GRAD_CASES)
                                        - set(ATTENTION_CASES)))
def test_split_blocks_forward_matches_one_process(units, outs, name):
    """The recurrent and enc-dec archs' logits, their vocab gathered
    whole, within 1e-5 of one process's relative to the largest logit:
    their forwards hold up to six row-parallel products, each rounding
    its partial sums in another order than one process's GEMM."""
    for o in outs:
        assert _logits_rel(o, units[1]["one"], name) <= GRAD_REL, name


# (case, a unit path) the step splits on a mesh whose "model" extent
# divides the case's heads (and channels), and leaves whole otherwise
UNIT_PATHS = {"rg": ("periods.slot0", "periods.slot0.mlp"),
              "xlstm": ("periods.slot0", "periods.slot3"),
              "xlstm_h2": ("periods.slot0", "periods.slot3"),
              "whisper": ("", "encoder.layer0.attn",
                          "decoder.layer1.cross_attn", "decoder.layer0.mlp",
                          "embed")}


def test_recurrent_units_split_where_the_heads_divide(outs):
    """The RG-LRU block and its MLP, the mLSTM and sLSTM blocks and every
    whisper unit (``dec_pos`` at the root path "") are split on every
    mesh; xlstm's with 2 heads only where "model" is 2 ranks."""
    for o in outs:
        m = max(int(x["model_index"]) for x in outs) + 1
        for name, paths in UNIT_PATHS.items():
            units = set(o[f"{name}/units"].tolist())
            split = not (name == "xlstm_h2" and m == 4)
            for path in paths:
                assert (path in units) == split, (name, path, m)


@pytest.mark.parametrize("arch,n", [("qwen2.5-3b", 11),
                                   ("recurrentgemma-9b", 53),
                                   ("granite-moe-3b-a800m", 9),
                                   ("xlstm-125m", 36), ("whisper-base", 99)])
def test_tp_leaves_are_the_attention_blocks_and_the_vocab(arch, n):
    """qwen: 7 attn leaves (q/k/v with biases), 3 mlp ones and the tied
    table; recurrentgemma: its local block's 4 attn and 3 mlp leaves, the
    table and the head, and each of its 4 RG-LRU leaves (two of each
    period and the two unrolled ones) 8 temporal leaves and 3 mlp ones;
    granite: 4 attn, 4 moe and the table; xlstm: 10 leaves of each of 3
    mLSTM blocks, 5 of its sLSTM block, and the table; whisper-base
    (enc-dec): each encoder layer's 4 attn and 2 mlp leaves, each decoder
    layer's 4 self_attn, 4 cross_attn and 2 mlp ones, the table, the
    head and ``dec_pos``.  No norm."""
    cfg = get_config(arch)
    keys = [k.split(".") for k in get_model(cfg).param_shapes()]
    got = [k for k in keys if TS.tp_leaf(cfg, k)]
    assert len(got) == n, [".".join(k) for k in got]
    for k in got:
        kind = TS.block_kind(cfg, k)
        if k[0] == "embed" or k == ["dec_pos"]:
            continue
        if cfg.is_encoder_decoder:
            assert k[-2] in ("attn", "self_attn", "cross_attn", "mlp"), k
        elif kind in TS.RECURRENT_KINDS and len(k) == 3:
            assert k[-1] in TS.TP_UNIT_LEAVES[kind], k
        else:
            assert kind in TS.ATTENTION_KINDS or k[-2] == "mlp", k
        assert not k[-2].startswith("ln"), k


def _mesh(**shape):
    return SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


SPEC_MESHES = {"1x2": _mesh(data=1, model=2), "2x2": _mesh(data=2, model=2),
               "1x4": _mesh(data=1, model=4)}


def _fold(spec) -> tuple:
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _model_entries(spec, ndim: int) -> tuple:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(e if e == "model" else None for e in spec)


@pytest.mark.parametrize("arch", list_archs())
def test_compute_specs_match_reference(arch):
    """``compute_pspec`` of every leaf (its period's slice for a stacked
    one) is the reference's 1d spec, and splits over "model" the dims
    the stored spec does."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    j1d = jcfg.replace(param_sharding="1d")
    shapes = get_model(cfg).param_shapes()
    for name, mesh in SPEC_MESHES.items():
        for key, (shape, _) in shapes.items():
            keys = key.split(".")
            inner = shape[1:] if keys[0] == "periods" else shape
            want = JS.param_pspec(j1d, mesh, keys, inner, stacked=False)
            got = TS.compute_pspec(cfg, mesh, keys, inner)
            assert _fold(got) == _fold(want), (name, key, got, want)
            stored = TS.param_pspec(cfg, mesh, keys, shape)
            stored = tuple(stored)[len(stored) - len(inner):]
            assert _model_entries(_fold(got), len(inner)) == \
                _model_entries(_fold(stored), len(inner)), (name, key)


PM_SHAPES = {"matrix": ((2, 5, 24), (24, 7)), "experts": ((3, 10, 24),
                                                          (3, 24, 7))}
PM_F32_REL = 1e-6
PM_BF16_REL = 2.0 ** -8


@pytest.mark.parametrize("what", ["forward", "autograd", "jvp",
                                  "linearize"])
@pytest.mark.parametrize("shape", sorted(PM_SHAPES))
def test_partial_matmul_is_the_f32_products_sum(shape, what):
    """bf16 operands, an f32 result: the same numbers as the f32
    upcast's product, and the same derivatives."""
    from repro_torch.models.layers import partial_matmul
    xs, ws = PM_SHAPES[shape]
    gen = torch.Generator().manual_seed(7)

    def draw(s):
        return torch.randn(s, generator=gen).to(torch.bfloat16)

    x, w, tx, tw = draw(xs), draw(ws), draw(xs), draw(ws)

    def upcast(a, b):
        return a.float() @ b.float()

    if what == "forward":
        got, want = partial_matmul(x, w), upcast(x, w)
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), want.numpy()) <= PM_F32_REL
    elif what == "autograd":
        ct = draw(upcast(x, w).shape).float()
        grads = []
        for f in (partial_matmul, upcast):
            a, b = (t.clone().requires_grad_(True) for t in (x, w))
            (f(a, b) * ct).sum().backward()
            grads.append((a.grad, b.grad))
        for got, want in zip(*grads):
            assert got.dtype == want.dtype == torch.bfloat16
            assert _rel(got.float().numpy(), want.float().numpy()) \
                <= PM_BF16_REL
    else:
        want = torch.func.jvp(upcast, (x, w), (tx, tw))[1]
        if what == "jvp":
            got = torch.func.jvp(partial_matmul, (x, w), (tx, tw))[1]
        else:
            _, lin = torch.func.linearize(partial_matmul, x, w)
            got = lin(tx, tw)
        assert _rel(got.numpy(), want.numpy()) <= PM_F32_REL
