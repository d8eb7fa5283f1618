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
}
ENC_SEED = 5


def lm_cfg(case: dict):
    """The case's smoke config at f32 compute in its storage regime."""
    from repro_torch.configs.base import get_config
    return get_config(case["arch"]).smoke().replace(
        compute_dtype="float32", param_sharding=case["sharding"])


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


def lm_update(params: dict, mesh, case: dict, **overrides) -> dict:
    """One update of ``case`` from the whole ``params`` through
    ``build_step`` on ``mesh`` (None: one process): the whole new
    parameters ("p.<key>", gathered on a mesh), this rank's shares of
    them ("share.<key>"), the scalar metrics ("m.<name>"), Adam's first
    moment whole ("adam_m.<key>", the gradient scaled) and, for each
    θ-sized state slot, its leaves' shapes on this rank ("shape.<slot>.
    <key>") beside the share its sharding gives ("want.<slot>.<key>")."""
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
    new, state, m = step(mine, opt.init(mine, state_sharding=ss),
                         lm_batch(case))
    out = {"m." + k: np.asarray(float(v)) for k, v in m.items()}
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

def lm_updates(*, tmp: str, mesh: str, cases: list) -> dict:
    """One update per case of ``LM_CASES`` on a ``mesh`` ("DxM") of this
    run's ranks, from the whole parameters of ``params_<arch>.npz``, keys
    "<case>/<name>"; an NGHF case's last CG iterate too (no candidate
    selection), "<case>/last.<key>"."""
    mesh = _mesh(mesh)
    out = {"data_index": np.asarray(mesh.data_index)}
    for case in cases:
        kw = LM_CASES[case]
        params = _load(tmp, f"params_{kw['arch']}.npz")
        for k, v in lm_update(params, mesh, kw).items():
            out[f"{case}/{k}"] = v
        if kw["optimizer"] == "nghf":
            last = lm_update(params, mesh, kw, eval_candidates=False)
            out.update({f"{case}/last.{k[2:]}": v for k, v in last.items()
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
