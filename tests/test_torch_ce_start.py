"""NGHF from a CE-pretrained LSTM and from a random start: the reference
and the port make the same decisions (ROADMAP §3.2's reference side, on
the CPU).

The LSTM (input 80, K = 6000 tied states, hidden cut from 1000 to 512 to
keep the test near half a minute) is CE-pretrained by the reference's
``train_sequence`` as the paper's example does it (Adam, 60 steps, batch
16, T = 32, lr 3e-3, seed 1000).  Its parameters cross with ``convert``,
and one NGHF update (gradient batch 64, CG batch 8, 6 CG and 2 NG
iterations, the share-counts preconditioner) runs in both packages on
the same batches.  Acceptance must agree, and the best iterate too — or
the two picks tie within the packages' spread of candidate losses, the
rule of ``chip_smoke.py::same_choice``.

From a random start with ``warm_start`` and ``adapt_lam`` (the LSTM at
hidden 256, K = 6000, T = 64, gradient batch 32, CG batch 8), three
NGHF updates run in both packages from the same parameters on the same
batches.  The outer CG's vᵀBv blows up within the first update, whose
accepted step is huge; the next update's gradient is non-finite.  Both
packages take the same decisions at every update, and reach their
first non-finite gradient at the same update.

    PYTHONPATH=src python tests/test_torch_ce_start.py [--hidden 1000]
    PYTHONPATH=src python tests/test_torch_ce_start.py --random-start \
        [--hidden 1000 --frames 200 --steps 3]

prints both packages' candidate losses, vᵀBv and decisions (the CE
start at full width takes about a minute on a CPU).
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.acoustic import LSTM  # noqa: E402
from repro.core import optim as joptim  # noqa: E402
from repro.data.synthetic import asr_batch as jax_batch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.losses.sequence import MPELoss  # noqa: E402
from repro.models import acoustic as JA  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.acoustic import LSTM as TLSTM  # noqa: E402
from repro_torch.data.synthetic import asr_batch  # noqa: E402
from repro_torch.launch.steps import build_sequence_step  # noqa: E402
from repro_torch.models import acoustic as TA  # noqa: E402

HIDDEN = 512
FRAMES = 32
KAPPA = 0.5
NGHF = dict(cg_iters=6, ng_iters=2)
KEYS = ("cg_accepted", "cg_best_iter", "cg_best_loss", "cg_losses",
        "cg_curv", "update_norm", "grad_norm", "logZ")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """PyTorch on one thread for this module: beside the suite's parallel
    workers the default thread pool oversubscribes the cores and
    multiplies the file's time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ce_start_update(hidden: int = HIDDEN) -> dict:
    """CE-pretrain in the reference, then one NGHF update in each
    package; {"jax": metrics, "torch": metrics} as numpy."""
    cfg, tcfg = (c.replace(hidden_dim=hidden) for c in (LSTM, TLSTM))
    base, _ = jtrain.train_sequence(
        acfg=cfg, optimizer="adam", loss="ce", steps=60, batch=16,
        frames=FRAMES, lr=3e-3, noise=1.2, seed=1000, verbose=False)

    def batches(make, **kw):
        return [make(seed, batch=n, num_frames=FRAMES,
                     num_states=cfg.num_outputs, input_dim=cfg.input_dim,
                     noise=1.2, **kw)
                for seed, n in ((0, 64), (1_000_000, 8))]

    def jfwd(p, b):
        return JA.forward(cfg, p, b["feats"]), 0.0

    jopt = joptim.get_optimizer("nghf", jfwd, MPELoss(kappa=KAPPA),
                                share_counts=JA.share_counts(cfg, base),
                                **NGHF)
    _, _, mj = jax.jit(jopt.step)(base, jopt.init(base),
                                  *batches(jax_batch))
    tp = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, base),
                                            device="cpu")
    _, opt = build_sequence_step(tcfg, "nghf", loss="mpe", kappa=KAPPA,
                                 share_counts=TA.share_counts(tcfg, tp),
                                 **NGHF)
    _, _, mt = opt.step(tp, opt.init(tp), *batches(asr_batch, device="cpu"))
    return {"jax": {k: np.asarray(mj[k]) for k in KEYS},
            "torch": {k: np.asarray(mt[k]) for k in KEYS}}


def random_start_updates(hidden: int = 256, frames: int = 64,
                         steps: int = 3) -> list:
    """NGHF with warm start and adaptive λ from the reference's random
    initialisation, ``steps`` updates in each package on the same
    batches (gradient batch 32, CG batch 8); a list of {"jax": metrics,
    "torch": metrics} per update."""
    cfg, tcfg = (c.replace(hidden_dim=hidden) for c in (LSTM, TLSTM))
    over = dict(NGHF, warm_start=True, adapt_lam=True)

    def batches(make, u, **kw):
        return [make(seed, batch=n, num_frames=frames,
                     num_states=cfg.num_outputs, input_dim=cfg.input_dim,
                     noise=1.2, **kw)
                for seed, n in ((u, 32), (1_000_000 + u, 8))]

    def jfwd(p, b):
        return JA.forward(cfg, p, b["feats"]), 0.0

    pj = JA.init_params(cfg, jax.random.PRNGKey(0))
    pt = convert.acoustic_params_from_numpy(jax.tree.map(np.asarray, pj),
                                            device="cpu")
    jopt = joptim.get_optimizer("nghf", jfwd, MPELoss(kappa=KAPPA), **over)
    jstep, sj = jax.jit(jopt.step), jopt.init(pj)
    _, topt = build_sequence_step(tcfg, "nghf", loss="mpe", kappa=KAPPA,
                                  **over)
    st = topt.init(pt)
    out = []
    for u in range(steps):
        pj, sj, mj = jstep(pj, sj, *batches(jax_batch, u))
        pt, st, mt = topt.step(pt, st, *batches(asr_batch, u, device="cpu"))
        out.append({"jax": {k: np.asarray(mj[k]) for k in KEYS},
                    "torch": {k: np.asarray(mt[k]) for k in KEYS}})
    return out


def same_choice(mj: dict, mt: dict) -> bool:
    """Acceptance equal; best iterate equal or a tie within twice the
    largest candidate-loss difference between the packages."""
    if bool(mj["cg_accepted"]) != bool(mt["cg_accepted"]):
        return False
    i, j = int(mj["cg_best_iter"]), int(mt["cg_best_iter"])
    lj, lt = mj["cg_losses"], mt["cg_losses"]
    both = np.isfinite(lj) & np.isfinite(lt)
    spread = float(np.abs(lj - lt)[both].max(initial=0.0))
    return i == j or (both[i] and both[j]
                      and abs(lj[i] - lj[j]) <= 2 * spread
                      and abs(lt[i] - lt[j]) <= 2 * spread)


def test_ce_start_nghf_makes_the_reference_decision():
    out = ce_start_update()
    mj, mt = out["jax"], out["torch"]
    assert same_choice(mj, mt), out
    # from a CE start the outer CG's curvature stays finite and positive
    # on both sides (a random start drives it to 1e14 at full width)
    for m in (mj, mt):
        assert np.all(np.isfinite(m["cg_curv"])) and m["cg_curv"][0] > 0
    np.testing.assert_allclose(mt["cg_curv"][0], mj["cg_curv"][0],
                               rtol=1e-3)


def test_random_start_warm_start_diverges_as_the_reference_does():
    ups = random_start_updates()
    for u, out in enumerate(ups):
        assert same_choice(out["jax"], out["torch"]), (u, out)
    # update 0: the outer CG's vᵀBv grows by more than 1e10 on both
    # sides, and agrees between them within 1e-2
    mj, mt = ups[0]["jax"], ups[0]["torch"]
    for m in (mj, mt):
        assert m["cg_curv"][-1] / m["cg_curv"][0] > 1e10, m["cg_curv"]
    np.testing.assert_allclose(mt["cg_curv"], mj["cg_curv"], rtol=1e-2)
    np.testing.assert_allclose(mt["update_norm"], mj["update_norm"],
                               rtol=1e-3)
    # the first non-finite gradient comes at the same update on both
    # sides, and from there every update is rejected with Δθ = 0
    first = [next((u for u, out in enumerate(ups)
                   if not np.isfinite(out[side]["grad_norm"])), None)
             for side in ("jax", "torch")]
    assert first[0] == first[1] == 1, first
    for out in ups[1:]:
        for m in out.values():
            assert not m["cg_accepted"] and m["update_norm"] == 0, m


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--random-start", action="store_true")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    if a.random_start:
        res = random_start_updates(a.hidden or 256, a.frames, a.steps)
    else:
        res = [ce_start_update(a.hidden or HIDDEN)]
    for u, out in enumerate(res):
        for side, m in out.items():
            print(u, side, {k: v.tolist() for k, v in m.items()})
        print(u, "same choice:", same_choice(out["jax"], out["torch"]))
