"""Port parity: ``lattice_stats`` against the JAX lattice engine.

The port's two backends — ``levelized`` (plain PyTorch) and ``cuda``
(the DAG-kernel backend, which on CPU tensors runs the kernels' plain
versions) — against the JAX package's ``levelized`` and ``pallas``
(interpret-mode Pallas kernels) backends, for both accumulator modes, on
one padded ragged batch: random DAGs and sausages of different arc
counts, plus a fully masked row, packed into one bucket.

Tolerance: rtol 1e-5, atol 1e-4.  f32 scores reach |alpha| ~ 60 at these
shapes (one ulp ~ 4e-6); XLA and PyTorch sum the cumsum grid and the
masked softmax rows in different orders, a few ulp apart.
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
from repro_torch.lattice_engine import (BACKENDS, lattice_stats,  # noqa: E402
                                        resolve_backend)

KAPPA = 0.5
K = 6
RTOL, ATOL = 1e-5, 1e-4
ACCUMULATORS = ("full", "loss_only")


def _ragged_dicts(seed=0):
    rng = np.random.default_rng(seed)
    out = [JL.make_random_dag_lattice(rng, num_frames=12, num_states=K),
           JL.make_sausage_lattice(rng, num_frames=16, num_states=K,
                                   n_alt=3),
           JL.make_random_dag_lattice(rng, num_frames=16, num_states=K),
           JL.make_sausage_lattice(rng, num_frames=8, num_states=K,
                                   n_alt=2)]
    masked = JL.make_sausage_lattice(rng, num_frames=8, num_states=K)
    masked["arc_mask"][:] = False
    masked["level_arcs"] = JL.levelize_arcs(masked["preds"],
                                            masked["is_start"],
                                            masked["arc_mask"])
    return out + [masked], rng


@pytest.fixture(scope="module")
def batch():
    """(numpy lattice fields, numpy log-probs, JAX results by backend and
    accumulators) of one padded ragged bucket."""
    dicts, rng = _ragged_dicts()
    spec = jpacking.derive_buckets(dicts, batch=len(dicts), tiers=1)[0]
    lat, _ = jpacking.pack_requests(dicts, spec)
    lp = rng.normal(0, 1, (spec.batch, spec.num_frames, K)).astype(
        np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    want = {}
    for backend in ("levelized", "pallas"):
        for acc in ACCUMULATORS:
            fn = jax.jit(lambda la, p, b=backend, a=acc: jax_stats(
                la, p, KAPPA, backend=b, accumulators=a))
            want[backend, acc] = jax.tree.map(np.asarray,
                                              fn(lat, jnp.asarray(lp)))
    fields = {f: np.asarray(getattr(lat, f)) for f in lat._fields}
    return fields, lp, want


@pytest.mark.parametrize("jax_backend", ("levelized", "pallas"))
@pytest.mark.parametrize("accumulators", ACCUMULATORS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_lattice_stats_matches_jax(batch, backend, accumulators,
                                   jax_backend):
    fields, lp, want = batch
    lat = convert.lattice_from_numpy(fields, device="cpu")
    got = lattice_stats(lat, torch.from_numpy(lp), KAPPA, backend=backend,
                        accumulators=accumulators)
    ref = want[jax_backend, accumulators]
    assert type(got).__name__ == type(ref).__name__
    assert got._fields == ref._fields
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(ref, name), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_loss_only_equals_full_within_port(batch):
    fields, lp, _ = batch
    lat = convert.lattice_from_numpy(fields, device="cpu")
    lpt = torch.from_numpy(lp)
    for backend in BACKENDS:
        full = lattice_stats(lat, lpt, KAPPA, backend=backend)
        lo = lattice_stats(lat, lpt, KAPPA, backend=backend,
                           accumulators="loss_only")
        torch.testing.assert_close(lo.logZ, full.logZ, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(lo.c_avg, full.c_avg, rtol=RTOL,
                                   atol=ATOL)


def test_backend_resolution_and_errors(batch):
    fields, lp, _ = batch
    lat = convert.lattice_from_numpy(fields, device="cpu")
    assert resolve_backend("auto", lat) == "levelized"
    assert resolve_backend("cuda", lat) == "cuda"
    with pytest.raises(ValueError, match="levelized"):
        resolve_backend("pallas", lat)
    with pytest.raises(ValueError, match="accumulators"):
        lattice_stats(lat, torch.from_numpy(lp), KAPPA,
                      accumulators="partial")
    with pytest.raises(ValueError, match="topology"):
        lattice_stats(lat, torch.from_numpy(lp), KAPPA, backend="cuda",
                      topology="sausage")
    # inputs that require grad are differentiated (the occupancy-identity
    # Functions), with the levelized backend's autograd as the oracle
    grads = []
    for backend in BACKENDS:
        lpg = torch.from_numpy(lp).requires_grad_()
        st = lattice_stats(lat, lpg, KAPPA, backend=backend)
        grads.append(torch.autograd.grad(st.logZ.sum() + st.c_avg.sum(),
                                         lpg)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=RTOL, atol=ATOL)


def test_log_semiring_helpers_match_jax():
    from repro.lattice_engine import common as jc
    from repro_torch.lattice_engine import common as tc
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (4, 5)).astype(np.float32)
    x[0] = tc.NEG                         # an all-masked row
    x[1, ::2] = tc.NEG
    for jf, tf in ((jc.masked_logsumexp, tc.masked_logsumexp),
                   (jc.masked_softmax, tc.masked_softmax)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jf(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-6)
    arr = rng.normal(size=6).astype(np.float32)
    idx = np.array([[0, -1, 5], [-1, -1, 2]], np.int32)
    np.testing.assert_array_equal(
        tc.gather_log(torch.from_numpy(arr), torch.from_numpy(idx)).numpy(),
        np.asarray(jc.gather_log(jnp.asarray(arr), jnp.asarray(idx))))
    np.testing.assert_array_equal(
        tc.gather_lin(torch.from_numpy(arr), torch.from_numpy(idx),
                      2.0).numpy(),
        np.asarray(jc.gather_lin(jnp.asarray(arr), jnp.asarray(idx), 2.0)))
