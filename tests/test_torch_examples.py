"""The port's twins of the reference's examples against the reference.

* ``repro_torch.examples.serve_batch`` (``launch.serve.main`` on
  xlstm-125m's smoke config with the reference's arguments) prints the
  same greedy tokens for the same requests as the reference's
  ``examples/serve_batch.py`` (its ``launch.serve.main`` with those
  arguments), given the reference's parameters (``jax.random.PRNGKey(0)``,
  carried across by ``convert.lm_params_from_numpy``), at f32 compute.
* ``repro_torch.examples.quickstart``'s first NGHF update of the smoke
  qwen2.5-3b, from the reference's parameters and on the same batch
  (``lm_batch``, bitwise equal in both packages), takes the reference
  quickstart's decision (``cg_accepted``, ``cg_best_iter``); its update
  Δθ (from the returned parameters) is the reference's within rel-L2
  2e-2, the LM update rule of PERF.md section 2, and so are
  ``update_norm`` and ``cg_best_loss`` relative; the ce of the gradient
  batch, a forward's mean over its tokens, is held within 1e-3 (bf16
  compute on both sides, as the examples run); then it decodes 8
  tokens.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import optim as joptim  # noqa: E402
from repro.data.synthetic import lm_batch as jbatch  # noqa: E402
from repro.launch import serve as JS  # noqa: E402
from repro.losses.chunked_lm import ChunkedCELoss as JCE  # noqa: E402
from repro.models.registry import get_model as jmodel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.examples import quickstart, serve_batch  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402

UPDATE_RTOL = 2e-2
CE_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_params(arch: str):
    cfg = jget(arch).smoke()
    return cfg, jmodel(cfg).init(jax.random.PRNGKey(0))


def _carried(jp) -> dict:
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _generated(text: str) -> list:
    return re.findall(r"^req \d+: prompt\[\d+\] -> \[.*\]$", text, re.M)


def _f32(get_config):
    return lambda arch: get_config(arch).replace(compute_dtype="float32")


def test_serve_batch_prints_the_reference_tokens(capsys, monkeypatch):
    """At f32 compute (patched into both packages' ``get_config``): at the
    example's bf16 the random smoke model's logits lie within bf16
    rounding of a tie, and the packages' tokens part a few steps in."""
    monkeypatch.setattr(JS, "get_config", _f32(JS.get_config))
    monkeypatch.setattr(TS, "get_config", _f32(TS.get_config))
    jcfg = JS.get_config("xlstm-125m").smoke()
    jp = jmodel(jcfg).init(jax.random.PRNGKey(0))
    JS.main(serve_batch.ARGS)
    want = _generated(capsys.readouterr().out)
    assert len(want) == 4
    tp = _carried(jp)
    monkeypatch.setattr(TR.Model, "init", lambda self, seed=0, device=None:
                        {k: v.to(device) for k, v in tp.items()})
    stats = serve_batch.main(["--device", "cpu"])
    assert _generated(capsys.readouterr().out) == want
    assert stats["tokens_per_s"] > 0


def test_quickstart_first_update_matches_the_reference(capsys):
    cfg, jp = _reference_params("qwen2.5-3b")
    model = jmodel(cfg)
    loss = JCE(t_chunk=32)

    def fwd(p, batch):
        hidden, aux = model.forward_hidden(p, batch)
        return (hidden, model.head_matrix(p)), cfg.router_aux_coef * aux

    opt = joptim.get_optimizer("nghf", fwd, loss, cg_iters=4, ng_iters=2,
                               lam=1.0)
    gb = jbatch(0, batch=quickstart.BATCH, seq_len=quickstart.SEQ,
                vocab=cfg.vocab_size)
    cb = jax.tree.map(lambda x: x[:quickstart.CG_ROWS], gb)
    new_j, _, want = jax.jit(opt.step)(jp, opt.init(jp), gb, cb)

    tmodel = TR.get_model(quickstart.CFG)
    params, log = quickstart.train(quickstart.CFG, tmodel, _carried(jp),
                                   steps=1, device="cpu")
    got = log[0]
    assert bool(got["cg_accepted"]) == bool(want["cg_accepted"])
    assert int(got["cg_best_iter"]) == int(want["cg_best_iter"])
    np.testing.assert_allclose(float(got["ce"]), float(want["ce"]),
                               rtol=CE_RTOL)
    for key in ("update_norm", "cg_best_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=UPDATE_RTOL, err_msg=key)
    before, after_j = _carried(jp), _carried(new_j)
    num = sum(float(torch.sum(((params[k] - before[k])
                               - (after_j[k] - before[k])).double() ** 2))
              for k in before)
    den = sum(float(torch.sum((after_j[k] - before[k]).double() ** 2))
              for k in before)
    assert num ** 0.5 <= UPDATE_RTOL * den ** 0.5
    assert "step 0: ce=" in capsys.readouterr().out
    sampled = quickstart.greedy(tmodel, params, device="cpu")
    assert len(sampled) == 8
    assert all(0 <= t < quickstart.CFG.vocab_size for t in sampled)
