"""Port parity: bucket packing and the rescoring service.

The service's results per request are held against the JAX service on
its kernel path (``backend="pallas"``, interpret-mode Pallas kernels):
the same synthetic workload from one seed through both.  Within the
port, batch-composition independence is bitwise: each utterance runs in
its own batch row (on the card, its own thread block), so which other
requests share a dispatch must not change a bit.

Tolerance against JAX: rtol 1e-5, atol 1e-4 — f32, with XLA and PyTorch
summing the cumsum grid and the softmax rows in different orders
(|logZ| <= 30 at these shapes, one ulp ~ 2e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import packing as jpacking  # noqa: E402
from repro.serving.service import RescoringService as JaxService  # noqa: E402
from repro.serving.service import synthetic_workload as jax_workload  # noqa: E402,E501
from repro_torch.serving import packing  # noqa: E402
from repro_torch.serving.metrics import latency_summary, percentile  # noqa: E402,E501
from repro_torch.serving.service import (RescoringService,  # noqa: E402
                                         synthetic_workload)

KAPPA = 0.5
K = 6
RTOL, ATOL = 1e-5, 1e-4


def _buckets(reqs, batch=4, tiers=2):
    return packing.derive_buckets([r.lattice for r in reqs], batch=batch,
                                  tiers=tiers)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX service's results on its Pallas kernel path."""
    reqs = jax_workload(0, 12)
    buckets = jpacking.derive_buckets([r.lattice for r in reqs], batch=4,
                                      tiers=2)
    svc = JaxService(buckets, kappa=KAPPA, backend="pallas")
    reqs, metrics = svc.run(reqs)
    return reqs, metrics


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def test_workload_identical_to_reference(jax_run):
    jreqs, _ = jax_run
    for jr, tr in zip(jreqs, synthetic_workload(0, 12)):
        assert jr.arrival_s == tr.arrival_s
        assert tuple(jr.dims) == tuple(tr.dims)
        np.testing.assert_array_equal(jr.log_probs, tr.log_probs)
        for k, v in jr.lattice.items():
            np.testing.assert_array_equal(v, tr.lattice[k])


def test_choose_bucket_smallest_fit_and_clear_error():
    dims = packing.LatticeDims(num_arcs=10, num_frames=8, num_levels=4,
                               level_width=4, fan=3)
    small = packing.BucketSpec(4, 16, 8, 4, 4, 4)
    big = packing.BucketSpec(4, 64, 32, 16, 16, 8)
    assert packing.choose_bucket(dims, [big, small]) == small
    with pytest.raises(ValueError, match="no bucket fits"):
        packing.choose_bucket(dims._replace(num_arcs=1000), [small, big])


def test_pack_requests_shapes_and_idle_slot_masking():
    reqs = synthetic_workload(1, 3)
    dicts = [r.lattice for r in reqs]
    spec = _buckets(reqs, tiers=1)[0]
    lat, n_live = packing.pack_requests(dicts, spec, device="cpu")
    assert n_live == 3
    assert lat.start_t.shape == (spec.batch, spec.num_arcs)
    assert lat.level_arcs.shape == (spec.batch, spec.num_levels,
                                    spec.level_width)
    assert lat.preds.shape == (spec.batch, spec.num_arcs, spec.fan)
    assert lat.ref_states.shape == (spec.batch, spec.num_frames)
    # the idle slot is fully masked: no valid arc, every level slot empty
    assert not lat.arc_mask[3].any()
    assert (lat.level_arcs[3] == -1).all()
    # live rows keep exactly their own arcs
    for i, d in enumerate(dicts):
        assert int(lat.arc_mask[i].sum()) == int(d["arc_mask"].sum())
    # the same packing as the reference, field by field
    jlat, _ = jpacking.pack_requests(dicts, spec)
    for f in lat._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jlat, f)),
                                      getattr(lat, f).numpy())
    lp = packing.pack_log_probs([r.log_probs for r in reqs], spec)
    assert lp.shape == (spec.batch, spec.num_frames, K)
    assert not lp[3].any()


def test_pack_oversize_rejected():
    reqs = synthetic_workload(1, 3)
    spec = packing.BucketSpec(2, 4, 4, 2, 2, 2)
    with pytest.raises(ValueError, match="exceed bucket"):
        packing.pad_to_bucket(reqs[1].lattice, spec)
    with pytest.raises(ValueError, match="batch=2"):
        packing.pack_requests([reqs[0].lattice] * 3, spec._replace(
            num_arcs=64, num_frames=32, num_levels=16, level_width=16,
            fan=8), device="cpu")


# ---------------------------------------------------------------------------
# service results against the JAX service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ("auto", "cuda"))
def test_run_matches_jax_service(jax_run, backend):
    jreqs, jmetrics = jax_run
    reqs = synthetic_workload(0, 12)
    svc = RescoringService(_buckets(reqs), kappa=KAPPA, backend=backend,
                           device="cpu")
    reqs, metrics = svc.run(reqs)
    assert metrics["completed"] == jmetrics["completed"] == 12
    assert metrics["dispatches"] >= 1
    assert all(c == 1 for c in svc.traces.values())
    for r, jr in zip(reqs, jreqs):
        assert r.status == jr.status == "ok"
        for key in ("logZ", "c_avg"):
            np.testing.assert_allclose(r.result[key], jr.result[key],
                                       rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", ("levelized", "cuda"))
def test_rescore_matches_jax_service(jax_run, backend):
    jreqs, _ = jax_run
    reqs = synthetic_workload(0, 12)
    svc = RescoringService(_buckets(reqs), kappa=KAPPA, backend=backend,
                           device="cpu")
    out = svc.rescore([r.lattice for r in reqs], [r.log_probs for r in reqs])
    for res, jr in zip(out, jreqs):
        for key in ("logZ", "c_avg"):
            np.testing.assert_allclose(res[key], jr.result[key], rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("backend", ("levelized", "cuda"))
def test_results_independent_of_batch_mix(backend):
    reqs = synthetic_workload(2, 6)
    spec = _buckets(reqs, batch=6, tiers=1)[0]
    svc = RescoringService([spec], kappa=KAPPA, backend=backend,
                           device="cpu")
    dicts = [r.lattice for r in reqs]
    lps = [r.log_probs for r in reqs]
    together = svc.dispatch(dicts, lps, spec)
    reverse = svc.dispatch(dicts[::-1], lps[::-1], spec)
    for i in range(len(reqs)):
        alone = svc.dispatch([dicts[i]], [lps[i]], spec)
        pair = svc.dispatch([dicts[(i + 1) % 6], dicts[i]],
                            [lps[(i + 1) % 6], lps[i]], spec)
        for k in range(2):
            assert together[k][i] == alone[k][0] == pair[k][1] \
                == reverse[k][5 - i]
    assert svc.traces[spec] == 1


# ---------------------------------------------------------------------------
# admission, deadlines, metrics
# ---------------------------------------------------------------------------

def test_service_admission_control_rejects_overflow():
    reqs = synthetic_workload(0, 6, rate_hz=500.0, num_states=K)
    for r in reqs:
        r.arrival_s = 0.0                  # all arrive at once
    svc = RescoringService(_buckets(reqs, batch=2, tiers=1), kappa=KAPPA,
                           max_queue=2, device="cpu")
    reqs, m = svc.run(reqs)
    assert m["rejected"] == 4 and m["completed"] == 2
    assert sum(r.status == "rejected" for r in reqs) == 4


def test_service_deadline_times_out():
    reqs = synthetic_workload(0, 4, rate_hz=500.0, num_states=K,
                              deadline_s=-1e-3)    # expired on arrival
    svc = RescoringService(_buckets(reqs, tiers=1), kappa=KAPPA,
                           device="cpu")
    reqs, m = svc.run(reqs)
    assert m["timeout"] == 4 and m["completed"] == 0
    assert all(r.result is None for r in reqs)


def test_service_rejects_bad_configuration():
    with pytest.raises(ValueError, match="BucketSpec"):
        RescoringService([], device="cpu")
    spec = packing.BucketSpec(1, 4, 4, 2, 2, 2)
    with pytest.raises(ValueError, match="unknown lattice backend"):
        RescoringService([spec], backend="pallas", device="cpu")


def test_percentile_conventions():
    assert np.isnan(percentile([], 50))
    assert percentile([3.0], 99) == 3.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5
    s = latency_summary([0.1, 0.2, 0.3])
    assert s["latency_p50_s"] == pytest.approx(0.2)
    assert s["latency_p99_s"] == pytest.approx(0.298)


def test_smoke_cli_on_cpu(capsys):
    from repro_torch.serving.service import main
    metrics = main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert metrics["completed"] == 12
    assert "bit-exact vs from-scratch: True" in out
