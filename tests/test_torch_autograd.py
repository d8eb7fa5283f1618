"""Port parity: derivatives of the lattice statistics.

∂logZ and ∂c_avg w.r.t. the log-probs, ``lm`` and ``corr`` — reverse
mode (``torch.autograd.grad`` and ``torch.func.grad``) and forward mode
(``torch.func.jvp``) — through

  * the ``cuda`` backend on CPU tensors: the occupancy-identity
    ``autograd.Function``s around the kernels' plain versions, sausage
    and DAG lattices, both accumulator modes;
  * the port's ``levelized`` backend, differentiated by autograd through
    its out-of-place level buffers;

against ``jax.grad`` and ``jax.jvp`` of the JAX package's ``pallas``
backend (custom_jvp occupancy identities around interpret-mode Pallas
kernels) on the same numpy inputs.  Also: the levelized backend's values
are bitwise those of the in-place level loop it replaced.

Tolerance: rtol 1e-4, atol 1e-5 — f32 derivatives of O(1) size; the
occupancies gamma = exp(alpha + beta - logZ) are formed from scores of
up to |s| ~ 60 summed in other orders on the two sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.lattice_engine import lattice_stats as jax_stats  # noqa: E402
from repro.losses import lattice as JL  # noqa: E402
from repro.serving import packing as jpacking  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.lattice_engine import (lattice_is_sausage,  # noqa: E402
                                        lattice_stats)
from repro_torch.lattice_engine import common as C  # noqa: E402
from repro_torch.lattice_engine import levelized as LV  # noqa: E402
from repro_torch.losses.lattice import lattice_frontiers  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5
KAPPA = 0.5
K = 5
W_CAVG = 2.0          # objective: sum(logZ) + W_CAVG * sum(c_avg)


def _sausage():
    return JL.make_lattice_batch(3, batch=3, num_frames=12, num_states=K)


def _dag():
    rng = np.random.default_rng(1)
    dicts = [JL.make_random_dag_lattice(rng, num_frames=12, num_states=K)
             for _ in range(3)]
    spec = jpacking.derive_buckets(dicts, batch=3, tiers=1)[0]
    return jpacking.pack_requests(dicts, spec)[0]


LATTICES = {"sausage": _sausage, "dag": _dag}
ACCUMULATORS = ("full", "loss_only")


def _inputs(lat, seed):
    rng = np.random.default_rng(seed)
    B, T = np.asarray(lat.ref_states).shape
    lp = rng.normal(0, 1, (B, T, K)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    A = np.asarray(lat.lm).shape[1]
    tangents = [rng.normal(size=s).astype(np.float32)
                for s in ((B, T, K), (B, A), (B, A))]
    return lp, tangents


@pytest.fixture(scope="module", params=sorted(LATTICES))
def case(request):
    """numpy lattice fields, inputs, tangents and JAX's grads/jvps for
    both accumulator modes."""
    lat = LATTICES[request.param]()
    lp, tangents = _inputs(lat, 0)
    want = {}
    for acc in ACCUMULATORS:
        def f(x, lm, corr, acc=acc):
            st = jax_stats(lat._replace(lm=lm, corr=corr), x, KAPPA,
                           backend="pallas", accumulators=acc)
            return jnp.sum(st.logZ) + W_CAVG * jnp.sum(st.c_avg)

        primals = (jnp.asarray(lp), lat.lm, lat.corr)
        grads = jax.grad(f, argnums=(0, 1, 2))(*primals)
        _, jv = jax.jvp(f, primals, tuple(jnp.asarray(t) for t in tangents))
        want[acc] = ([np.asarray(g) for g in grads], float(jv))
    fields = {f: np.asarray(getattr(lat, f)) for f in lat._fields}
    return request.param, fields, lp, tangents, want


def _objective(lat, backend, acc):
    def f(x, lm, corr):
        st = lattice_stats(lat._replace(lm=lm, corr=corr), x, KAPPA,
                           backend=backend, accumulators=acc)
        return st.logZ.sum() + W_CAVG * st.c_avg.sum()
    return f


def _port(fields):
    return convert.lattice_from_numpy(fields, device="cpu")


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("acc", ACCUMULATORS)
@pytest.mark.parametrize("backend", ["cuda", "levelized"])
def test_autograd_matches_jax_grad(case, backend, acc):
    name, fields, lp, _, want = case
    lat = _port(fields)
    assert lattice_is_sausage(lat) is (name == "sausage")
    x = torch.from_numpy(lp).requires_grad_()
    lm = lat.lm.clone().requires_grad_()
    corr = lat.corr.clone().requires_grad_()
    out = _objective(lat, backend, acc)(x, lm, corr)
    _close(torch.autograd.grad(out, (x, lm, corr)), want[acc][0])


@pytest.mark.parametrize("acc", ACCUMULATORS)
@pytest.mark.parametrize("backend", ["cuda", "levelized"])
def test_func_grad_and_jvp_match_jax(case, backend, acc):
    _, fields, lp, tangents, want = case
    lat = _port(fields)
    f = _objective(lat, backend, acc)
    primals = (torch.from_numpy(lp), lat.lm, lat.corr)
    _close(torch.func.grad(f, argnums=(0, 1, 2))(*primals), want[acc][0])
    _, jv = torch.func.jvp(f, primals,
                           tuple(torch.from_numpy(t) for t in tangents))
    np.testing.assert_allclose(float(jv), want[acc][1], rtol=RTOL,
                               atol=10 * ATOL)


def test_full_path_launches_one_pass_per_call(case, monkeypatch):
    """ONE forward and ONE backward recursion per full-statistics call,
    and none more for its gradient (the Function saves the occupancies)."""
    from repro_torch.lattice_engine import cuda_backend as CB
    name, fields, lp, _, _ = case
    lat = _port(fields)
    calls = []
    for fn in ("sausage_forward", "sausage_backward", "dag_forward",
               "dag_backward"):
        orig = getattr(CB, fn)
        monkeypatch.setattr(CB, fn, lambda *a, _o=orig, _n=fn:
                            calls.append(_n) or _o(*a))
    x = torch.from_numpy(lp).requires_grad_()
    st = lattice_stats(lat, x, KAPPA, backend="cuda")
    torch.autograd.grad(st.logZ.sum() + st.c_avg.sum(), x)
    kind = "sausage" if name == "sausage" else "dag"
    assert calls == [f"{kind}_forward", f"{kind}_backward"]


def _inplace_levels(lat, lp):
    """The levelized recursion as it was written before: level slices
    assigned in place (a frozen copy of the arithmetic)."""
    B, L, W = lat.level_arcs.shape
    A, LW = lat.num_arcs, L * W
    fr = lattice_frontiers(lat)
    am = C.arc_scores(lat, lp, KAPPA) + lat.lm
    from repro_torch.kernels.ref import gather_sausage_ref
    own = gather_sausage_ref(am, lat.level_arcs, C.NEG)
    corr = gather_sausage_ref(lat.corr.float(), lat.level_arcs, 0.0)
    P, S = fr.pidx.shape[-1], fr.sidx.shape[-1]
    alpha = torch.full((B, LW + 1), C.NEG)
    c_alpha = torch.zeros((B, LW + 1))
    for lv in range(L):
        idx = fr.pidx[:, lv].reshape(B, W * P).long()
        pa = alpha.gather(1, idx).reshape(B, W, P)
        pc = c_alpha.gather(1, idx).reshape(B, W, P)
        in_log = C.masked_logsumexp(pa, dim=-1)
        c_in = (C.masked_softmax(pa, dim=-1) * pc).sum(dim=-1)
        st, ok = fr.start[:, lv], fr.ok[:, lv]
        a_val = torch.where(st, own[:, lv], own[:, lv] + in_log)
        c_val = corr[:, lv] + torch.where(st, torch.zeros_like(c_in), c_in)
        alpha[:, lv * W:(lv + 1) * W] = torch.where(
            ok, a_val, torch.full_like(a_val, C.NEG))
        c_alpha[:, lv * W:(lv + 1) * W] = torch.where(
            ok, c_val, torch.zeros_like(c_val))
    own_pad = torch.cat([own.reshape(B, -1), torch.full((B, 1), C.NEG)], 1)
    corr_pad = torch.cat([corr.reshape(B, -1), torch.zeros((B, 1))], 1)
    beta = torch.full((B, LW + 1), C.NEG)
    c_beta = torch.zeros((B, LW + 1))
    for lv in range(L - 1, -1, -1):
        idx = fr.sidx[:, lv].reshape(B, W * S).long()
        s_out = torch.where(idx < LW, beta.gather(1, idx)
                            + own_pad.gather(1, idx),
                            torch.full(idx.shape, C.NEG)).reshape(B, W, S)
        sc = (c_beta.gather(1, idx) + corr_pad.gather(1, idx)).reshape(
            B, W, S)
        out_log = C.masked_logsumexp(s_out, dim=-1)
        c_out = (C.masked_softmax(s_out, dim=-1) * sc).sum(dim=-1)
        fin, ok = fr.final[:, lv], fr.ok[:, lv]
        b_val = torch.where(fin, torch.zeros_like(out_log), out_log)
        c_val = torch.where(fin, torch.zeros_like(c_out), c_out)
        beta[:, lv * W:(lv + 1) * W] = torch.where(
            ok, b_val, torch.full_like(b_val, C.NEG))
        c_beta[:, lv * W:(lv + 1) * W] = torch.where(
            ok, c_val, torch.zeros_like(c_val))

    def arcs(buf, fill):
        return torch.where(lat.arc_mask, C.from_level_major(
            buf[:, :LW], fr.arc_pos, A, fill), torch.full_like(am, fill))
    return C.finalize(lat, arcs(alpha, C.NEG), arcs(beta, C.NEG),
                      arcs(c_alpha, 0.0), arcs(c_beta, 0.0))


def test_levelized_values_bitwise_unchanged(case):
    _, fields, lp, _, _ = case
    lat = _port(fields)
    x = torch.from_numpy(lp)
    got = LV.forward_backward_levelized(lat, x, KAPPA)
    want = _inplace_levels(lat, x)
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    alpha, c_alpha = LV.forward_alpha_levelized(lat, x, KAPPA)
    assert torch.equal(alpha, want.alpha)
    assert torch.equal(c_alpha, want.c_alpha)
