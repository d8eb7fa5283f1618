"""Rank code of the port's FSDP tests (``tests/test_torch_fsdp.py``,
``tests/test_torch_mesh_lm.py``), run by ``torch_mesh_worker.start`` as
``"torch_mesh_lm_worker:<task>"``: gloo over the CPU, one process a
rank, one thread each.

Like ``torch_mesh_worker`` this module imports ``torch`` and
``repro_torch`` only, never JAX: the tests compute the reference's
results in the pytest process and pass numpy arrays in and out through
files of a temporary directory.
"""
from __future__ import annotations

import io
import os
import zipfile

import numpy as np
import torch
import torch.distributed as dist

# one NGHF update as the reference's acceptance test runs it
# (tests/test_sharding.py::test_lm_fsdp_nghf_step_matches_single_device)
NGHF = dict(cg_iters=2, ng_iters=1, preconditioner="fisher_diag",
            warm_start=True)
CG_FRAC, MIN_CG = 2, 4
SEQ = 16
LM_CASES = {
    "plain": dict(arch="qwen2.5-3b", sharding="2d", batch=8,
                  optimizer="nghf", opt=NGHF),
    "fused": dict(arch="qwen2.5-3b", sharding="2d", batch=8,
                  optimizer="nghf", opt=dict(NGHF, cg_fused=True)),
    # a gradient batch 4 data ranks cannot split (kept whole on every
    # rank); its CG batch of 4 splits
    "b6": dict(arch="qwen2.5-3b", sharding="2d", batch=6,
               optimizer="nghf", opt=NGHF),
    "granite": dict(arch="granite-moe-3b-a800m", sharding="2d", batch=8,
                    optimizer="nghf", opt=NGHF),
    "whisper_adam": dict(arch="whisper-base", sharding="1d", batch=8,
                         optimizer="adam", opt=dict(lr=3e-4)),
    # windowed attention (window 16 at T 16) on each rank's heads
    "mixtral": dict(arch="mixtral-8x22b", sharding="2d", batch=8,
                    optimizer="nghf", opt=NGHF),
    "rg": dict(arch="recurrentgemma-9b", sharding="2d", batch=8,
               optimizer="nghf", opt=NGHF),
    # the mLSTM and sLSTM blocks on each rank's heads (1d, as xlstm-125m)
    "xlstm": dict(arch="xlstm-125m", sharding="1d", batch=8,
                  optimizer="nghf", opt=NGHF),
    # the capacity dispatch MoE on split rows and a split expert set
    "granite_dispatch": dict(arch="granite-moe-3b-a800m", sharding="2d",
                             batch=8, optimizer="nghf", opt=NGHF,
                             over=dict(moe_impl="dispatch")),
}
ENC_SEED = 5


def lm_cfg(case: dict):
    """The case's smoke config at f32 compute in its storage regime."""
    from repro_torch.configs.base import get_config
    return get_config(case["arch"]).smoke().replace(
        compute_dtype="float32", param_sharding=case["sharding"],
        **case.get("over", {}))


def encoder_input(cfg, n: int) -> np.ndarray:
    """An enc-dec arch's (B, F, d) frame embeddings, from a numpy seed."""
    return np.random.default_rng(ENC_SEED).normal(
        size=(n, cfg.encoder_frames, cfg.d_model)).astype(np.float32)


def lm_batch(case: dict) -> dict:
    """The case's global batch: ``lm_batch(0)`` (bitwise the reference's),
    with ``encoder_input`` for an enc-dec arch."""
    from repro_torch.data.synthetic import lm_batch as draw
    cfg = lm_cfg(case)
    b = draw(0, batch=case["batch"], seq_len=SEQ, vocab=cfg.vocab_size,
             device="cpu")
    if cfg.is_encoder_decoder:
        b["encoder_input"] = torch.from_numpy(
            encoder_input(cfg, case["batch"]))
    return b


def share_shape(sharding, shape) -> tuple:
    """The shape of this rank's share of a leaf of ``shape``."""
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    return tuple(n if e is None else n // sharding.mesh.extent(e)
                 for n, e in zip(shape, spec))


class _Watch:
    """Within the block, every ``fsdp.gather_for_compute`` result's leaf
    shapes by parameter path ("used.<path>", a stacked leaf's period
    slice) and the count of ``_Gather`` launches over the model group
    ("model_gathers") and over any group ("gathers")."""

    def __init__(self, mesh):
        self.mesh, self.out = mesh, {"model_gathers": 0, "gathers": 0}

    def __enter__(self):
        from repro_torch.launch import fsdp
        from repro_torch.models.transformer import flatten
        self.gather, self.apply = fsdp.gather_for_compute, fsdp._Gather.apply
        model = fsdp._group_id(self.mesh.group("model"))

        def gather(tree, compute_dtype=None, prefix=""):
            got = self.gather(tree, compute_dtype, prefix)
            for k, v in flatten(got, prefix).items():
                self.out["used." + k] = np.asarray(v.shape)
            return got

        def apply(x, dim, gid, data):
            self.out["gathers"] += 1
            self.out["model_gathers"] += gid == model
            return self.apply(x, dim, gid, data)

        fsdp.gather_for_compute, fsdp._Gather.apply = gather, apply
        return self.out

    def __exit__(self, *exc):
        from repro_torch.launch import fsdp
        fsdp.gather_for_compute, fsdp._Gather.apply = self.gather, self.apply


def lm_update(params: dict, mesh, case: dict, **overrides) -> dict:
    """One update of ``case`` from the whole ``params`` through
    ``build_step`` on ``mesh`` (None: one process): the whole new
    parameters ("p.<key>", gathered on a mesh), this rank's shares of
    them ("share.<key>"), the scalar metrics ("m.<name>"), Adam's first
    moment whole ("adam_m.<key>", the gradient scaled) and, for each
    θ-sized state slot, its leaves' shapes on this rank ("shape.<slot>.
    <key>") beside the share its sharding gives ("want.<slot>.<key>");
    on a mesh, the shapes the model used each leaf at and the gathers
    (``_Watch``)."""
    from repro_torch.launch import fsdp
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.steps import build_step
    cfg = lm_cfg(case)
    ss = None if mesh is None else param_shardings(cfg, mesh, params)
    mine = params if mesh is None else {k: ss[k].place(v)
                                        for k, v in params.items()}
    step, opt = build_step(cfg, case["optimizer"], cg_frac=CG_FRAC,
                           min_cg=MIN_CG, mesh=mesh, state_sharding=ss,
                           **dict(case["opt"], **overrides))
    state = opt.init(mine, state_sharding=ss)
    watch = {}
    if mesh is None:
        new, state, m = step(mine, state, lm_batch(case))
    else:
        with _Watch(mesh) as watch:
            new, state, m = step(mine, state, lm_batch(case))
    out = {k: np.asarray(v) for k, v in watch.items()}
    out.update({"m." + k: np.asarray(float(v)) for k, v in m.items()})
    for k, v in new.items():
        out["share." + k] = v.numpy()
        out["p." + k] = (v if mesh is None
                         else fsdp.gather_whole(v, ss[k])).numpy()
    for k, v in (state.get("m") or {}).items():     # Adam's first moment
        out["adam_m." + k] = (v if mesh is None
                              else fsdp.gather_whole(v, ss[k])).numpy()
    slots = {"delta": state.get("delta"),
             "d": state.get("precond", {}).get("d"),
             "m": state.get("m")}
    for slot, tree in slots.items():
        for k, v in (tree or {}).items():
            out[f"shape.{slot}.{k}"] = np.asarray(v.shape)
            out[f"want.{slot}.{k}"] = np.asarray(
                v.shape if mesh is None
                else share_shape(ss[k], params[k].shape))
    return out


def _mesh(spec: str):
    from repro_torch.launch.mesh import make_debug_mesh
    d, m = (int(v) for v in spec.split("x"))
    return make_debug_mesh(d, m, device="cpu")


def _load(tmp: str, name: str) -> dict:
    with np.load(os.path.join(tmp, name)) as f:
        return {k: torch.from_numpy(f[k].copy()) for k in f.files}


# ---------------------------------------------------------------------------
# tasks: each runs on every rank and returns a dict of numpy arrays
# ---------------------------------------------------------------------------

def lm_updates(*, tmp: str, mesh: str, cases: list, last: bool = True
               ) -> dict:
    """One update per case of ``LM_CASES`` on a ``mesh`` ("DxM") of this
    run's ranks, from the whole parameters of ``params_<arch>.npz``, keys
    "<case>/<name>"; with ``last`` an NGHF case's last CG iterate too (no
    candidate selection), "<case>/last.<key>"."""
    mesh = _mesh(mesh)
    out = {"data_index": np.asarray(mesh.data_index)}
    for case in cases:
        kw = LM_CASES[case]
        params = _load(tmp, f"params_{kw['arch']}.npz")
        for k, v in lm_update(params, mesh, kw).items():
            out[f"{case}/{k}"] = v
        if last and kw["optimizer"] == "nghf":
            it = lm_update(params, mesh, kw, eval_candidates=False)
            out.update({f"{case}/last.{k[2:]}": v for k, v in it.items()
                        if k.startswith("p.")})
    return out


def lm_resume(*, tmp: str, mesh: str) -> dict:
    """Three NGHF updates of the qwen2.5-3b smoke model in 2d storage
    through ``train_lm`` on ``mesh`` uninterrupted, and two then a resume
    to three from the checkpoint; this rank's shares of both runs'
    parameters, and the checkpoint's parameter shapes (whole leaves)."""
    from repro_torch.launch.train import train_lm
    mesh = _mesh(mesh)
    kw = dict(arch="qwen2.5-3b", smoke=True, param_sharding="2d",
              optimizer="nghf", batch=8, seq=SEQ, cg_iters=2, ng_iters=1,
              warm_start=True, preconditioner="fisher_diag", device="cpu",
              mesh=mesh, verbose=False)
    full, _ = train_lm(steps=3, **kw)
    ck = os.path.join(tmp, "ck")
    train_lm(steps=2, ckpt_dir=ck, **kw)
    resumed, log = train_lm(steps=3, ckpt_dir=ck, resume=True, **kw)
    out = {"full." + k: v.numpy() for k, v in full.items()}
    out.update({"resumed." + k: v.numpy() for k, v in resumed.items()})
    out["resumed_steps"] = np.asarray([e["step"] for e in log])
    with np.load(os.path.join(ck, "arrays.npz")) as f:
        out.update({"ckpt_shape." + k: np.asarray(f[k].shape)
                    for k in f.files if k.startswith("params/")})
    return out


# --- the gather, reductions and checkpoint on their own ---------------------

def _specs(mesh) -> dict:
    """Leaves of every kind: split over data and model, data only, model
    only, replicated, and a stacked leaf split over both."""
    from repro_torch.launch.sharding import P
    return {"w2d": ((8, 6), P("data", "model")),
            "wd": ((8, 5), P("data", None)),
            "wm": ((3, 6), P(None, "model")),
            "v": ((5,), P()),
            "periods.slot0.w": ((2, 8, 6), P(None, "data", "model"))}


def _toy(p: dict, x, prefix: str = ""):
    """A small model over the leaves of ``_specs``, calling
    ``gather_for_compute`` where it uses them (the model's pattern)."""
    from repro_torch.launch import fsdp
    from repro_torch.models.transformer import nest
    top = fsdp.gather_for_compute({k: p[k] for k in ("w2d", "wd", "wm",
                                                       "v")}, torch.float32)
    y = torch.tanh(x @ top["w2d"]) @ top["wm"].T
    z = (x @ top["wd"]) * top["v"]
    outs = [y, z]
    for i in range(2):
        s = fsdp.gather_for_compute(nest(p, "periods.slot0.", i),
                                    torch.float32, "periods.slot0.")
        outs.append(torch.sin(x @ s["w"]))
    return torch.cat(outs, -1)


def fsdp_units(*, tmp: str, mesh: str) -> dict:
    """On a ``mesh`` of this run's ranks: ``Mesh.group`` of a 2d leaf; the
    gather Function against the whole leaves (forward, ``torch.func.jvp``,
    ``vjp`` and ``torch.autograd`` on split and on whole rows,
    ``linearize``, the cast before the gather); ``tree_math.vdot`` and
    ``norm`` over split trees; a gathering ``save_checkpoint`` against a
    one-process save of the whole tree."""
    from repro_torch.checkpoint import io as cio
    from repro_torch.core import tree_math as tm
    from repro_torch.core.curvature import batch_sum
    from repro_torch.core.optim.base import (data_splits, split_groups,
                                             split_replicas)
    from repro_torch.launch import fsdp
    from repro_torch.launch.sharding import NamedSharding
    mesh = _mesh(mesh)
    world = dist.get_world_size()
    out = {"group_2d": np.asarray([
        dist.get_world_size(mesh.group(("data", "model"))) == world,
        mesh.group(("model", "data")) is mesh.group(("data", "model")),
        dist.get_world_size(mesh.group("data")) == mesh.shape["data"],
        dist.get_world_size(mesh.group("model")) == mesh.shape["model"]])}

    gen = torch.Generator().manual_seed(7)
    specs = _specs(mesh)
    ss = {k: NamedSharding(mesh, spec) for k, (_, spec) in specs.items()}
    whole = {k: torch.randn(shape, generator=gen)
             for k, (shape, _) in specs.items()}
    tan = {k: torch.randn(shape, generator=gen)
           for k, (shape, _) in specs.items()}
    B = 4 * mesh.data_extent
    x = torch.randn(B, 8, generator=gen)
    ct = torch.randn(B, 3 + 5 + 12, generator=gen)
    mine = {k: ss[k].place(v) for k, v in whole.items()}
    tmine = {k: ss[k].place(v) for k, v in tan.items()}
    n = B // mesh.data_extent
    rows = slice(mesh.data_index * n, (mesh.data_index + 1) * n)
    reg = fsdp.compute_specs(mesh, {k: s.spec for k, s in ss.items()},
                             cast=False)

    def piece(tree):
        return {k: ss[k].place(v) for k, v in tree.items()}

    want_y = _toy(whole, x)
    want_j = torch.func.jvp(lambda p: _toy(p, x), (whole,), (tan,))[1]
    _, pull = torch.func.vjp(lambda p: _toy(p, x), whole)
    want_g = piece(pull(ct)[0])
    with reg:
        out["forward"] = np.asarray(torch.equal(_toy(mine, x), want_y))
        j = torch.func.jvp(lambda p: _toy(p, x), (mine,), (tmine,))[1]
        out["jvp"] = (j - want_j).abs().max().numpy()
        lin_y, lin = torch.func.linearize(lambda p: _toy(p, x), mine)
        out["linearize"] = np.asarray(max(
            float((lin(tmine) - want_j).abs().max()),
            float((lin({k: 2 * v for k, v in tmine.items()})
                   - 2 * want_j).abs().max()),
            float((lin_y - want_y).abs().max())))
        # whole rows on every rank: each leaf's gradient is its slice
        with fsdp.batch_rows(None):
            _, pull = torch.func.vjp(lambda p: _toy(p, x), mine)
        g = pull(ct)[0]
        out["vjp_whole_rows"] = np.asarray(max(
            float((g[k] - want_g[k]).abs().max()) for k in g))
        # split rows: the gathers reduce-scatter over data, batch_sum
        # sums the other leaves over the data group
        group = mesh.data_group
        with fsdp.batch_rows(group):
            _, pull = torch.func.vjp(lambda p: _toy(p, x[rows]), mine)
        g = batch_sum(pull(ct[rows])[0], group, mesh, data_splits(ss))
        out["vjp_split_rows"] = np.asarray(max(
            float((g[k] - want_g[k]).abs().max()) for k in g))
        leaves = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
        with fsdp.batch_rows(group):
            (_toy(leaves, x[rows]) * ct[rows]).sum().backward()
        g = batch_sum({k: v.grad for k, v in leaves.items()}, group, mesh,
                      data_splits(ss))
        out["autograd_split_rows"] = np.asarray(max(
            float((g[k] - want_g[k]).abs().max()) for k in g))
    # the cast before the gather (2d storage): matrices move in the
    # compute dtype, vectors stay f32
    with fsdp.compute_specs(mesh, {k: s.spec for k, s in ss.items()},
                            cast=True):
        got = fsdp.gather_for_compute({k: mine[k] for k in ("w2d", "v")},
                                      torch.bfloat16)
    out["cast"] = np.asarray([
        got["w2d"].dtype == torch.bfloat16,
        torch.equal(got["w2d"], whole["w2d"].to(torch.bfloat16)),
        got["v"].dtype == torch.float32, torch.equal(got["v"], whole["v"])])

    # vdot / norm over the split tree, against the whole tree
    layout = tm.Layout({k: tuple(v.shape) for k, v in mine.items()},
                       split_groups(ss), split_replicas(ss))
    with tm.reducing(layout):
        got = torch.stack([tm.vdot(mine, tmine), tm.norm(mine)])
    want = torch.stack([tm.vdot(whole, tan), tm.norm(whole)])
    out["vdot_norm"] = got.numpy()
    out["vdot_norm_want"] = want.numpy()

    # a gathering save against a one-process save of the whole tree
    ck = os.path.join(tmp, f"ck_mesh{mesh.shape['data']}"
                      f"x{mesh.shape['model']}")
    tree = {"params": mine, "opt_state": {"step": torch.tensor(3)}}
    cio.save_checkpoint(ck, tree, step=3, shardings={"params": ss})
    if dist.get_rank() == 0:
        one = ck + "_one"
        cio.save_checkpoint(one, {"params": whole,
                                  "opt_state": {"step": torch.tensor(3)}},
                            step=3)
        out["ckpt_same"] = np.asarray(_members(ck) == _members(one))
    else:
        out["ckpt_same"] = np.asarray(True)
    back, _ = cio.load_checkpoint(ck, tree, shardings={"params": ss})
    out["ckpt_load"] = np.asarray(all(
        torch.equal(back["params"][k], mine[k]) for k in mine))
    return out


def _members(ckpt_dir: str) -> dict:
    """{member: bytes} of a checkpoint: ``manifest.json`` and every array
    of ``arrays.npz`` (the zip's own entry times aside)."""
    with open(os.path.join(ckpt_dir, "manifest.json"), "rb") as f:
        out = {"manifest.json": f.read()}
    with open(os.path.join(ckpt_dir, "arrays.npz"), "rb") as f:
        with zipfile.ZipFile(io.BytesIO(f.read())) as z:
            out.update({n: z.read(n) for n in z.namelist()})
    return out


# --- tensor-parallel compute on its own -------------------------------------

# the replicated-inside-TP gradients: qwen2.5-3b's smoke with its q/k
# norms on (2 kv heads: whole on every rank of a 4-way "model"), granite's
# (4 experts, one a rank on 1x4) and granite's with 2 experts (4 ranks
# then split every expert's columns); recurrentgemma's (the RG-LRU blocks
# by channels, their MLPs by columns, the local block's one kv head whole
# on every rank), xlstm's (the mLSTM and sLSTM blocks by heads), whisper's
# (an enc-dec arch: every attention, MLP, the vocab and ``dec_pos``), and
# xlstm's with 2 heads (whole mLSTM and sLSTM units on a 4-way "model").
# Every decoder-only case runs with sequence-parallel activations on a
# "model" extent above 1 (T 16, its batch of 4 split over the data ranks).
TP_GRAD_CASES = {
    "qwen_qk": dict(arch="qwen2.5-3b", over=dict(qk_norm=True)),
    "granite": dict(arch="granite-moe-3b-a800m", over={}),
    "granite_e2": dict(arch="granite-moe-3b-a800m",
                       over=dict(num_experts=2)),
    "rg": dict(arch="recurrentgemma-9b", over={}),
    "xlstm": dict(arch="xlstm-125m", over={}),
    "whisper": dict(arch="whisper-base", over={}),
    "xlstm_h2": dict(arch="xlstm-125m", over=dict(num_heads=2)),
}
# the cases of ``tests/test_torch_sequence_parallel.py``: where sequence
# parallelism runs (qwen with its 2 kv heads whole on 1x4, recurrentgemma,
# granite's MoE router) and where it falls back or runs a unit whole: T
# 15, which "model" does not divide; a batch of 3, which 2 data ranks do
# not split (kept whole on every rank, as ``b6`` on 4 data ranks); xlstm
# with 2 heads (its units whole on 1x4, the stream split); granite with an
# odd vocabulary (its embedding and head whole on every rank, as
# granite-moe-3b-a800m's 49155) and with the dispatch MoE
SP_CASES = {
    "qwen_qk": TP_GRAD_CASES["qwen_qk"],
    "rg": TP_GRAD_CASES["rg"],
    "xlstm_h2": TP_GRAD_CASES["xlstm_h2"],
    "qwen_t15": dict(arch="qwen2.5-3b", over={}, seq=15),
    "qwen_b3": dict(arch="qwen2.5-3b", over={}, batch=3),
    "granite_v511": dict(arch="granite-moe-3b-a800m",
                         over=dict(vocab_size=511)),
    "granite_dispatch": dict(arch="granite-moe-3b-a800m",
                             over=dict(moe_impl="dispatch")),
}
TP_BATCH = 4
# the vector leaves the reference draws as zeros and ones, moved off them
# (``tests/torch_perturb.py``'s names): a gradient of a norm's leaves that
# misses another rank's T rows shows
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm", "scale", "bias")


def tp_case(name: str) -> dict:
    return {**SP_CASES, **TP_GRAD_CASES}[name]


def tp_grad_cfg(name: str):
    from repro_torch.configs.base import get_config
    kw = tp_case(name)
    return get_config(kw["arch"]).smoke().replace(
        compute_dtype="float32", param_sharding="2d", **kw["over"])


def _toy_tp(p: dict, split):
    """y = g(tanh((f(x) * f(u)) @ w1) @ w2): w1 column-parallel, w2
    row-parallel, u a leaf used whole inside the split region (``split``
    the toy's ``fsdp.Split``, or None: the whole toy)."""
    from repro_torch.launch import tensor_parallel as tp
    x, u = p["x"], p["u"]
    if split:
        x, u = tp.copy_to_model(x, split), tp.copy_to_model(u, split)
    y = torch.tanh((x * u) @ p["w1"]) @ p["w2"]
    return tp.reduce_from_model(y, split) if split else y


def _toy_gather(p: dict, split):
    """y = g(tanh(tanh(gather(f(x) @ w1) @ w2) @ w3)): w1 and w2
    column-parallel, w2 reading all of w1's output (``gather_from_model``),
    w3 row-parallel (``split`` the toy's ``fsdp.Split``, or None: the
    whole toy)."""
    from repro_torch.launch import tensor_parallel as tp
    x = tp.copy_to_model(p["x"], split) if split else p["x"]
    a = torch.tanh(x @ p["w1"])
    if split:
        a = tp.gather_from_model(a, split)
    y = torch.tanh(a @ p["w2"]) @ p["w3"]
    return tp.reduce_from_model(y, split) if split else y


def _toy_sp(p: dict, seq):
    """With the stream split over T by ``seq`` (a ``fsdp.Split``; None:
    the whole toy), y = x + leave(tanh(enter(x * f(u)) @ w1) @ w2) and
    z = y + leave(tanh(enter(y) @ w3)): u a leaf used on the T slice, w1
    column-parallel and w2 row-parallel (a split unit), w3 whole on every
    rank (a whole unit).  ``x`` is the rank's T slice under ``seq``."""
    from repro_torch.launch import fsdp
    from repro_torch.launch import tensor_parallel as tp
    split = seq and fsdp.Split("columns", seq.group, seq.index, seq.extent)
    u = tp.copy_to_model(p["u"], seq) if seq else p["u"]
    with fsdp.sequence_rows(seq):
        a = torch.tanh(tp.enter(p["x"] * u, split) @ p["w1"])
        y = p["x"] + tp.leave(a @ p["w2"], split, a.dtype)
        b = torch.tanh(tp.enter(y, None) @ p["w3"])
        return y + tp.leave(b, None, b.dtype)


def _sp_toy(mesh, r: int, m: int, gen) -> dict:
    """``_toy_sp`` on this rank's T slice and its shares against the
    whole toy: the forward, ``torch.func.jvp``, ``linearize``, ``vjp``
    and autograd, the largest difference over the largest entry of the
    whole toy's (its T slice, or this rank's share of a gradient)."""
    from repro_torch.launch import fsdp
    B, T, d, n = 2, 4 * m, 6, 8
    shapes = {"x": (B, T, d), "u": (d,), "w1": (d, n), "w2": (n, d),
              "w3": (d, d)}
    whole = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    tan = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    ct = torch.randn(B, T, d, generator=gen)
    c, t = n // m, T // m
    rows = slice(r * t, (r + 1) * t)

    def share(tree):
        tree = dict(tree)
        tree["x"] = tree["x"][:, rows].contiguous()
        tree["w1"] = tree["w1"][:, r * c:(r + 1) * c].contiguous()
        tree["w2"] = tree["w2"][r * c:(r + 1) * c].contiguous()
        return tree

    seq = fsdp.Split("sequence", mesh.group("model"), r, m)
    want_y = _toy_sp(whole, None)[:, rows]
    want_j = torch.func.jvp(lambda q: _toy_sp(q, None), (whole,),
                            (tan,))[1][:, rows]
    _, pull = torch.func.vjp(lambda q: _toy_sp(q, None), whole)
    want_g = share(pull(ct)[0])
    mine, tmine = share(whole), share(tan)

    def rel(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    out = {"forward": rel(_toy_sp(mine, seq), want_y)}
    out["jvp"] = rel(torch.func.jvp(lambda q: _toy_sp(q, seq), (mine,),
                                    (tmine,))[1], want_j)
    lin_y, lin = torch.func.linearize(lambda q: _toy_sp(q, seq), mine)
    out["linearize"] = max(rel(lin(tmine), want_j),
                           rel(lin({k: 2 * v for k, v in tmine.items()}),
                               2 * want_j), rel(lin_y, want_y))
    _, pull = torch.func.vjp(lambda q: _toy_sp(q, seq), mine)
    g = pull(ct[:, rows])[0]
    out["vjp"] = max(rel(g[k], want_g[k]) for k in want_g)
    leaves = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
    (_toy_sp(leaves, seq) * ct[:, rows]).sum().backward()
    out["autograd"] = max(rel(leaves[k].grad, want_g[k]) for k in want_g)
    return {"sp_toy_" + k: np.asarray(v) for k, v in out.items()}


# the dispatch MoE on its own: (E, k) with capacity factor 1.25 at 64
# (token, expert) pairs, most tokens routed to the first experts, so that
# pairs are dropped: E 4 splits by experts over 2 or 4 "model" ranks, E 3
# by every expert's columns
DISPATCH = {"experts": (4, 2), "columns": (3, 2)}
DISPATCH_SHAPE = (4, 8, 16, 8)                  # B, T, d, d_ff


def dispatch_cfg(E: int, k: int):
    from repro_torch.configs.base import get_config
    _, _, d, ff = DISPATCH_SHAPE
    return get_config("granite-moe-3b-a800m").smoke().replace(
        compute_dtype="float32", d_model=d, d_ff=ff, num_experts=E,
        num_experts_per_tok=k, moe_impl="dispatch")


def dispatch_inputs(E: int, seed: int = 21) -> dict:
    """x, the router (its first two columns along x's common direction),
    the expert matrices and the output's cotangent, from a numpy seed."""
    B, T, d, ff = DISPATCH_SHAPE
    rng = np.random.default_rng(seed + E)
    base = rng.normal(size=d)
    x = 0.3 * rng.normal(size=(B, T, d)) + base
    router = 0.3 * rng.normal(size=(d, E))
    router[:, 0] += base / (base @ base) * 3.0
    router[:, 1] += base / (base @ base) * 2.0
    out = dict(x=x, router=router,
               w_in=rng.normal(size=(E, d, ff)) / d ** 0.5,
               w_gate=rng.normal(size=(E, d, ff)) / d ** 0.5,
               w_out=rng.normal(size=(E, ff, d)) / ff ** 0.5,
               ct=rng.normal(size=(B, T, d)), aux_ct=np.asarray(0.7))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _dispatch(mesh, r: int, m: int) -> dict:
    """``moe_apply_dispatch`` on this rank's rows (split over the data
    group) and T slice (with the stream split, where "model" spans
    ranks), its share of the experts or of their columns: the output, the
    aux share and the dropped pairs (``layers.dispatch_drops``), and the
    gradients of (out · ct) + aux_ct · aux by autograd: x's (its rows and
    T slice), the router's and the experts' shares (their data-group sums
    are the test's to take)."""
    from repro_torch.launch import fsdp
    from repro_torch.models import layers as L
    out = {}
    B, T, _, _ = DISPATCH_SHAPE
    nb, t = B // mesh.data_extent, T // m
    rows = slice(mesh.data_index * nb, (mesh.data_index + 1) * nb)
    cols = slice(r * t, (r + 1) * t)
    for by, (E, k) in DISPATCH.items():
        cfg = dispatch_cfg(E, k)
        x = {n: torch.from_numpy(v) for n, v in dispatch_inputs(E).items()}
        split = None
        leaves = {"router": x["router"]}
        for n in ("w_in", "w_gate", "w_out"):
            w = x[n]
            if m > 1 and by == "experts":
                w = w[r * E // m:(r + 1) * E // m]
            elif m > 1:
                dim = 1 if n == "w_out" else 2
                f = w.shape[dim] // m
                w = w.narrow(dim, r * f, f)
            leaves[n] = w.contiguous()
        leaves = {n: v.clone().requires_grad_(True) for n, v in leaves.items()}
        p = dict(leaves)
        if m > 1:
            split = fsdp.Split(by, mesh.group("model"), r, m)
            p = fsdp.SplitUnit(p, split, frozenset({"router"}))
        h = x["x"][rows][:, cols if m > 1 else slice(None)].clone()
        h.requires_grad_(True)
        seq = (fsdp.Split("sequence", mesh.group("model"), r, m) if m > 1
               else None)
        group = mesh.data_group if mesh.data_extent > 1 else None
        with fsdp.batch_rows(group), fsdp.sequence_rows(seq), \
                L.dispatch_drops() as drops:
            y, aux = L.moe_apply_dispatch(cfg, p, h)
        ct = x["ct"][rows][:, cols if m > 1 else slice(None)]
        ((y * ct).sum() + x["aux_ct"] * aux).backward()
        out[f"dispatch_{by}/out"] = y.detach().numpy()
        out[f"dispatch_{by}/aux"] = aux.detach().numpy()
        out[f"dispatch_{by}/drops"] = np.asarray([int(c) for c in drops])
        out[f"dispatch_{by}/g.x"] = h.grad.numpy()
        for n, v in leaves.items():
            out[f"dispatch_{by}/g.{n}"] = v.grad.numpy()
    return out


class _Record:
    """Within the block: the residual stream's shape at every block
    boundary (``models.blocks.block_apply``'s input and output, in call
    order, "residual") and every collective (``fsdp.collective_log``)
    as strings "<kind> <model|other> <shape> <bytes an element>" with
    their calls ("coll", "coll_calls")."""

    def __init__(self, mesh):
        self.mesh, self.shapes = mesh, []

    def __enter__(self):
        from repro_torch.launch import fsdp
        from repro_torch.models import blocks
        self.apply = blocks.block_apply

        def apply(cfg, kind, p, x, positions):
            y, aux = self.apply(cfg, kind, p, x, positions)
            self.shapes += [tuple(x.shape), tuple(y.shape)]
            return y, aux

        blocks.block_apply = apply
        self.log = fsdp.collective_log()
        self.counts = self.log.__enter__()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks.block_apply = self.apply
        self.log.__exit__(*exc)

    def arrays(self) -> dict:
        from repro_torch.launch import fsdp
        model = fsdp._group_id(self.mesh.group("model"))
        keys = sorted(self.counts)
        return {"residual": np.asarray(self.shapes).reshape(-1, 3),
                "coll": np.asarray([
                    f"{kind} {'model' if gid == model else 'other'} "
                    f"{'x'.join(map(str, shape))} {size}"
                    for kind, gid, shape, size in keys] or [""]),
                "coll_calls": np.asarray([self.counts[k] for k in keys]
                                         or [0])}


def tp_units(*, tmp: str, mesh: str, cases=None, products: bool = True
             ) -> dict:
    """On a ``mesh`` of this run's ranks, with tensor-parallel compute
    registered: f and g on a toy under the forward, ``torch.func.jvp``,
    ``linearize``, ``vjp`` and autograd against the whole toy; the
    vocab-parallel embedding and the chunked CE (loss, acc, gradient, GN
    and Fisher factors) on ``ce_inputs.npz`` against the whole vocab's
    (whose results go back for the reference); ``gather_from_model`` on a
    second toy likewise; the sequence-parallel unit edges on a third
    (``_sp_toy``); the dispatch MoE on split rows, T and experts
    (``_dispatch``); each case of ``cases`` (``TP_GRAD_CASES``' by
    default; ``SP_CASES``' too): its gradient through ``core.curvature.
    grad_and_loss`` (the residual stream's shapes and the collectives
    recorded, ``_Record``) and, with ``products``, a GN product in both
    curvature modes, whole, its forward's logits on the whole batch and on this rank's
    rows (the vocab gathered whole) and the paths of the units it split;
    the test process holds them against one process's
    (``tp_one_process``)."""
    import torch.nn.functional as F
    from repro_torch.configs.base import get_config
    from repro_torch.core import tree_math as tm
    from repro_torch.core.curvature import grad_and_loss, make_curvature_ops
    from repro_torch.core.optim.base import (data_splits, split_groups,
                                             split_replicas)
    from repro_torch.launch import fsdp
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.launch.sharding import P, param_shardings
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    mesh = _mesh(mesh)
    m = mesh.shape["model"]
    r = dict(zip(mesh.axis_names, mesh.device_mesh.get_coordinate()))["model"]
    out = {"model_index": np.asarray(r)}

    # f and g on the toy
    gen = torch.Generator().manual_seed(11)
    shapes = {"x": (4, 6), "u": (6,), "w1": (6, 8), "w2": (8, 6)}
    whole = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    tan = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    ct = torch.randn(4, 6, generator=gen)
    n = 8 // m

    def share(t):
        t = dict(t)
        t["w1"] = t["w1"][:, r * n:(r + 1) * n].contiguous()
        t["w2"] = t["w2"][r * n:(r + 1) * n].contiguous()
        return t

    out.update(_sp_toy(mesh, r, m, torch.Generator().manual_seed(13)))
    out.update(_dispatch(mesh, r, m))

    ce_cfg = get_config("qwen2.5-3b").smoke()
    with np.load(os.path.join(tmp, "ce_inputs.npz")) as f:
        ce = {k: torch.from_numpy(f[k].copy()) for k in f.files}
    ce_cfg = ce_cfg.replace(vocab_size=ce["W"].shape[1])
    def reg():
        return fsdp.compute_specs(mesh, {"embed.table": P("model", None)},
                                  cast=False, cfg=ce_cfg)
    toy = fsdp.Split("columns", mesh.group("model"), r, m)

    want_y = _toy_tp(whole, None)
    want_j = torch.func.jvp(lambda p: _toy_tp(p, None), (whole,), (tan,))[1]
    _, pull = torch.func.vjp(lambda p: _toy_tp(p, None), whole)
    want_g = share(pull(ct)[0])
    mine, tmine = share(whole), share(tan)
    def rel(got, want) -> float:
        return float((got - want).abs().max() / want.abs().max())

    def rel_tree(got, want) -> float:
        return max(rel(got[k], want[k]) for k in want)

    with reg():
        out["toy_forward"] = np.asarray(rel(_toy_tp(mine, toy), want_y))
        j = torch.func.jvp(lambda p: _toy_tp(p, toy), (mine,), (tmine,))[1]
        out["toy_jvp"] = np.asarray(rel(j, want_j))
        lin_y, lin = torch.func.linearize(lambda p: _toy_tp(p, toy), mine)
        out["toy_linearize"] = np.asarray(max(
            rel(lin(tmine), want_j),
            rel(lin({k: 2 * v for k, v in tmine.items()}), 2 * want_j),
            rel(lin_y, want_y)))
        _, pull = torch.func.vjp(lambda p: _toy_tp(p, toy), mine)
        out["toy_vjp"] = np.asarray(rel_tree(pull(ct)[0], want_g))
        leaves = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
        (_toy_tp(leaves, toy) * ct).sum().backward()
        out["toy_autograd"] = np.asarray(rel_tree(
            {k: v.grad for k, v in leaves.items()}, want_g))

    # gather_from_model on its toy: w1, w2 by columns, w3 by rows
    gshapes = {"x": (4, 6), "w1": (6, 8), "w2": (8, 8), "w3": (8, 6)}
    gwhole = {k: torch.randn(s, generator=gen) for k, s in gshapes.items()}
    gtan = {k: torch.randn(s, generator=gen) for k, s in gshapes.items()}

    def gshare(t):
        t = dict(t)
        for k in ("w1", "w2"):
            t[k] = t[k][:, r * n:(r + 1) * n].contiguous()
        t["w3"] = t["w3"][r * n:(r + 1) * n].contiguous()
        return t

    want_y = _toy_gather(gwhole, None)
    want_j = torch.func.jvp(lambda p: _toy_gather(p, None), (gwhole,),
                            (gtan,))[1]
    _, pull = torch.func.vjp(lambda p: _toy_gather(p, None), gwhole)
    want_g = gshare(pull(ct)[0])
    mine, tmine = gshare(gwhole), gshare(gtan)
    with reg():
        out["gtoy_forward"] = np.asarray(rel(_toy_gather(mine, toy), want_y))
        j = torch.func.jvp(lambda p: _toy_gather(p, toy), (mine,),
                           (tmine,))[1]
        out["gtoy_jvp"] = np.asarray(rel(j, want_j))
        lin_y, lin = torch.func.linearize(lambda p: _toy_gather(p, toy), mine)
        out["gtoy_linearize"] = np.asarray(max(
            rel(lin(tmine), want_j),
            rel(lin({k: 2 * v for k, v in tmine.items()}), 2 * want_j),
            rel(lin_y, want_y)))
        _, pull = torch.func.vjp(lambda p: _toy_gather(p, toy), mine)
        out["gtoy_vjp"] = np.asarray(rel_tree(pull(ct)[0], want_g))
        leaves = {k: v.clone().requires_grad_(True) for k, v in mine.items()}
        (_toy_gather(leaves, toy) * ct).sum().backward()
        out["gtoy_autograd"] = np.asarray(rel_tree(
            {k: v.grad for k, v in leaves.items()}, want_g))

    # the vocab-parallel embedding and chunked CE
    V = ce["W"].shape[1]
    nv = V // m
    cols = slice(r * nv, (r + 1) * nv)
    loss = ChunkedCELoss(t_chunk=int(ce["t_chunk"]))
    batch = {"labels": ce["y"]}

    def run_ce(W, uW, split: bool):
        res = {}
        table = ce["table"][cols] if split else ce["table"]
        table = table.clone().requires_grad_(True)
        vocab = fsdp.unit_split("embed")
        emb = (tp.vocab_embed(ce["tokens"], table, torch.float32, vocab)
               if split else F.embedding(ce["tokens"], table))
        (emb * ce["ct_e"]).sum().backward()
        res["emb"], res["emb_grad"] = emb.detach(), table.grad
        h = ce["h"].clone().requires_grad_(True)
        Wg = W.clone().requires_grad_(True)
        hidden = tp.copy_to_model(h, vocab) if split else h
        val, met = loss.value((hidden, Wg), batch)
        val.backward()
        res.update(loss=val.detach(), acc=met["acc"], grad_h=h.grad,
                   grad_W=Wg.grad)
        for kind in ("gn_vp", "fisher_vp"):
            ch, cw = getattr(loss, kind)((ce["h"], W), batch, (ce["uh"], uW))
            if split:       # the backbone's copy_to_model sums it
                ch = tp.all_reduce(ch, mesh.group("model"))
            res[kind + "_h"], res[kind + "_W"] = ch, cw
        return res

    if m > 1:               # a vocabulary split over "model"
        whole_ce = run_ce(ce["W"], ce["uW"], False)
        with reg():
            split_ce = run_ce(ce["W"][:, cols].contiguous(),
                              ce["uW"][:, cols].contiguous(), True)
        for k, v in whole_ce.items():
            out["ce_whole." + k] = v.numpy()
            out["ce_split." + k] = split_ce[k].numpy()
        out["ce_cols"] = np.asarray([cols.start, cols.stop])

    # gradients and GN products of whole models (the test process holds
    # them against one process's, ``tp_one_process``)
    from repro_torch.data.pipeline import batch_splits, shard_batch
    out["data_index"] = np.asarray(mesh.data_index)
    for name in (TP_GRAD_CASES if cases is None else cases):
        cfg, model, params, b, fwd, spec, v = _tp_case(name)
        ss = param_shardings(cfg, mesh, params)
        mine = {k: ss[k].place(p) for k, p in params.items()}
        vmine = {k: ss[k].place(t) for k, t in v.items()}
        split = data_splits(ss)
        layout = tm.Layout({k: tuple(p.shape) for k, p in mine.items()},
                           split_groups(ss), split_replicas(ss))
        with fsdp.step_context(cfg, mesh, ss), tm.reducing(layout):
            out[f"{name}/units"] = np.asarray(
                sorted(fsdp._REGISTRY.get().units), dtype=str)
            with _Record(mesh) as rec:
                _, _, g = grad_and_loss(fwd, spec, mine, b, mesh=mesh,
                                        data_split=split)
            out.update({f"{name}/{k}": a for k, a in rec.arrays().items()})
            gv = {mode: make_curvature_ops(fwd, spec, mine, b, mode=mode,
                                           mesh=mesh, data_split=split
                                           ).gnvp(vmine)
                  for mode in (("rematvp", "linearize") if products else ())}
            dots = torch.stack([tm.vdot(g, vmine), tm.norm(g)])
            with torch.no_grad():
                out[f"{name}/logits"] = model.forward(mine, b)[0].numpy()
                rows = batch_splits(b, mesh)
                with fsdp.batch_rows(mesh.data_group if rows else None):
                    out[f"{name}/logits_rows"] = model.forward(
                        mine, shard_batch(b, mesh))[0].numpy()
        out[f"{name}/dots"] = dots.numpy()
        for k in params:
            out[f"{name}/g.{k}"] = fsdp.gather_whole(g[k], ss[k]).numpy()
            out[f"{name}/share.{k}"] = np.asarray(g[k].shape)
            for mode in gv:
                out[f"{name}/gv_{mode}.{k}"] = fsdp.gather_whole(
                    gv[mode][k], ss[k]).numpy()
    return out


def _tp_case(name: str):
    """(cfg, model, whole parameters (the norms' scales and biases, the
    q/k/v biases and q/k norms moved off their initial values), batch,
    forward, loss, tangent) of a ``TP_GRAD_CASES`` or ``SP_CASES`` case,
    the same on every rank and in the test process."""
    from repro_torch.data.synthetic import lm_batch as draw
    from repro_torch.launch.steps import lm_forward
    from repro_torch.losses.chunked_lm import ChunkedCELoss
    from repro_torch.models.registry import get_model
    cfg = tp_grad_cfg(name)
    model = get_model(cfg)
    rng = np.random.default_rng(17)
    params = {k: p + 0.1 * torch.from_numpy(
                  rng.normal(size=p.shape).astype(np.float32))
              if k.split(".")[-1] in PERTURBED else p
              for k, p in model.init(0, device="cpu").items()}
    n = tp_case(name).get("batch", TP_BATCH)
    b = draw(0, batch=n, seq_len=tp_case(name).get("seq", SEQ),
             vocab=cfg.vocab_size, device="cpu")
    b["labels"] = b["tokens"]
    if cfg.is_encoder_decoder:
        b["encoder_input"] = torch.from_numpy(encoder_input(cfg, n))
    gen = torch.Generator().manual_seed(3)
    v = {k: torch.randn(p.shape, generator=gen) * 1e-2
         for k, p in params.items()}
    return (cfg, model, params, b, lm_forward(cfg, model), ChunkedCELoss(),
            v)


def tp_one_process(name: str, products: bool = True) -> dict:
    """One process's gradient ("g_one.<key>"), with ``products`` GN
    products in both curvature modes ("gv_one_<mode>.<key>"),
    ``vdot``/``norm`` ("dots_one") and logits ("logits_one") of
    ``tp_units``' case ``name``."""
    from repro_torch.core import tree_math as tm
    from repro_torch.core.curvature import grad_and_loss, make_curvature_ops
    cfg, model, params, b, fwd, spec, v = _tp_case(name)
    _, _, g = grad_and_loss(fwd, spec, params, b)
    out = {"dots_one": torch.stack([tm.vdot(g, v), tm.norm(g)]).numpy()}
    for mode in ("rematvp", "linearize") if products else ():
        gv = make_curvature_ops(fwd, spec, params, b, mode=mode).gnvp(v)
        out.update({f"gv_one_{mode}.{k}": t.numpy() for k, t in gv.items()})
    out.update({f"g_one.{k}": t.numpy() for k, t in g.items()})
    with torch.no_grad():
        out["logits_one"] = model.forward(params, b)[0].numpy()
    return out
