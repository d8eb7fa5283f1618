"""The kernel sanitizer of the port.

    python -m repro_torch.analysis.sanitize_kernels [--device cpu|cuda]
        [--self-test] [--report sanitizer_report.json]

Port of ``repro.analysis.sanitize_kernels``.  It checks the port's
kernel layer (``src/repro_torch/kernels/``) on the device asked for, the
card by default as for every entry point of the port:

  1. a dynamic pass runs every public lattice wrapper over the
     adversarial lattice corpus (``analysis.corpus``: zero-arc
     utterance, single-level DAG, max fan-in, padded batch row, packed
     serving bucket, and a bucket whose state passes the shared memory,
     so the DAG kernels keep it in global scratch and
     ``sausage_loss_only`` spills), each in f32 and bf16, captures every
     launch with ``kernels.instrument.capture_calls`` and applies the
     ``rules_kernel`` checks: KS001 launch structure, KS002 frontier
     invariants, KS003 gather bounds of the captured index operands,
     KS004 agreement with the plain versions and finiteness;
  2. the vector kernels at small shapes: ``swa_attention`` on both
     routes (the tensor cores at bf16 with hd % 8 == 0, the CUDA cores at
     f32 and through ``cuda_core_swa_attention``), ``swa_attention_vjp``
     and ``swa_attention_jvp`` on both, the tensor-core three again at hd
     128 and 256, and ``cg_fused_update`` in f32 and bf16;
  3. the precision-flow audit (KS005): each wrapper run on small real
     bf16 tensors keeps its sums in f32.

On the card each capture also checks that its ``"cuda"`` records equal
the ``kernels.build.launch`` calls made inside it (no launch slips past
the hook).  On both devices every launcher of the seven CUDA libraries
must have run, the tensor-core ones at hd_pad 64, 128 and 256, and the
global-state and spill branches must have been captured.  On the card
KS001 then also sums each launch's dynamic shared bytes with its
kernel's static shared memory from ptxas.  On the CPU the wrappers take
their plain versions and record the launch the card would make
(``route="plain"``), so KS001-KS003 see the same plan and index operands
there.

Why on the card too: ``csrc/lattice_dag.cu`` reads an out-of-range
frontier position as NEG / 0, so an off-by-one in a caller's frontier
gives a plausible wrong logZ with no fault and no crash; only KS003 on
the captured operands sees it.

``--self-test`` also proves the rules have teeth: the seeded mutants in
``tests/fixtures/torch_sanitizer/`` (an off-by-one frontier gather into
the real ``dag_forward`` and a loss-only sum cast back to bf16) must be
flagged by KS003 and KS005, and the real kernels must be clean.  Exit
code 1 on any failure, else 0.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.analysis import corpus, rules_kernel
from repro_torch.analysis.rules_kernel import STEM_OF
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels import swa_attention as SWA
from repro_torch.kernels.cg_fused import cg_fused_update
from repro_torch.kernels.instrument import capture_calls
from repro_torch.kernels.lattice_fb import (dag_backward, dag_forward,
                                            dag_loss_only, sausage_backward,
                                            sausage_forward,
                                            sausage_loss_only)
from repro_torch.kernels.ref import NEG
from repro_torch.losses.lattice import lattice_frontiers

FIXTURES_DIR = Path(__file__).resolve().parents[3] / "tests" / "fixtures" \
    / "torch_sanitizer"
_KAPPA = 0.5
F32, BF16 = torch.float32, torch.bfloat16
# (tag, dtype, tolerance) of the dynamic passes, the reference's
_LATTICE_DTYPES = (("f32", F32, 1e-4), ("bf16", BF16, 1e-2))
_VECTOR_DTYPES = (("f32", F32, 1e-4), ("bf16", BF16, 3e-2))
# the attention's small case: B, T, H, K, hd (G = 2, a ragged last tile)
_SWA_SHAPE, _SWA_WINDOW = (2, 40, 4, 2, 64), 16
# the tensor-core tiles of the wider heads (mixtral's hd 128,
# recurrentgemma's 256), whose shared memory comes closest to a block's
_SWA_WIDE = [(1, 40, 4, 2, hd) for hd in (128, 256)]
_CG_N = 70_000                  # two tiles of cg_fused.TILE, the last ragged


def _log_probs(lat, T, K, seed, dtype=F32):
    rng = np.random.default_rng(seed)
    B = int(lat.arc_mask.shape[0])
    lp = torch.from_numpy(rng.normal(0.0, 1.0, size=(B, T, K))
                          .astype(np.float32)).log_softmax(-1)
    return lp.to(lat.arc_mask.device, dtype)


def _arc_scores(lat, log_probs):
    return ref.sausage_arc_scores_ref(log_probs, lat.start_t, lat.end_t,
                                      lat.label, _KAPPA) \
        + lat.lm.to(F32)


def _sausage_layout(lat, log_probs):
    """(scores, corr, mask) in the (B, S, W) sausage layout via the plain
    versions' own gather helper: the kernel pair's shared inputs."""
    def g(v, fill):
        return ref.gather_sausage_ref(v.to(F32), lat.level_arcs, fill)
    return (g(_arc_scores(lat, log_probs), 0.0), g(lat.corr, 0.0),
            g(lat.arc_mask, 0.0))


def _dag_layout(lat, log_probs):
    """(own, corr, start, ok, final) in the (B, L, W) level-major layout:
    the general-DAG kernel pair's shared inputs."""
    def g(v, fill):
        return ref.gather_sausage_ref(v.to(F32), lat.level_arcs, fill)
    ok = g(lat.arc_mask, 0.0)
    return (g(_arc_scores(lat, log_probs), NEG), g(lat.corr, 0.0),
            g(lat.is_start, 0.0) * ok, ok, g(lat.is_final, 0.0) * ok)


def _loss_only_args(lat, log_probs):
    return (log_probs, lat.start_t, lat.end_t, lat.label, lat.lm, lat.corr,
            lat.arc_mask)


class _Tally:
    """Records and launches over a run: the records of each launcher, the
    ``build.launch`` calls the captures saw, and KS001's launch facts."""

    def __init__(self, facts: dict):
        self.facts = facts
        self.launchers: Dict[str, int] = {}
        self.records = 0
        self.build_launches = 0
        self.ks001: Dict[str, dict] = {}

    def check(self, recs) -> List[str]:
        fails: List[str] = []
        for r in recs:
            fails += rules_kernel.check_call_structure(
                r, static=self.facts.get("static"),
                dynamic_smem=self.facts.get("dynamic"))
            fails += rules_kernel.check_gather_bounds(r)
            seen = self.ks001.setdefault(r.name, {})
            for key in ("threads", "smem", "gstride", "scratch"):
                if key in r.config:
                    seen.setdefault(key, set()).add(r.config[key])
            if "geometry" in r.config:
                hd_pad = r.config["geometry"].hd_pad
                seen.setdefault("hd_pad", set()).add(hd_pad)
                smem = self.facts.get("dynamic", {}).get((r.name, hd_pad))
                if smem is not None:
                    seen.setdefault("smem", set()).add(smem)
            first = next(iter(r.operands.values()))
            seen.setdefault("dtype", set()).add(
                str(first.dtype).replace("torch.", ""))
        for r in recs:
            self.launchers[r.name] = self.launchers.get(r.name, 0) + 1
        cuda = sum(r.route == "cuda" for r in recs)
        self.records += len(recs)
        self.build_launches += recs.launches
        if cuda != recs.launches:
            fails.append(f"capture: {cuda} cuda records but "
                         f"{recs.launches} build.launch calls: a launch "
                         f"slipped past the hook")
        return fails


def _sanitize_case(name: str, case_fn, dev, tally: _Tally
                   ) -> Tuple[Dict, List[str]]:
    """Every lattice wrapper over one corpus case (f32 and bf16 inputs):
    capture the launches and apply KS001-KS004."""
    lat, T, K = case_fn(device=dev)
    fr = lattice_frontiers(lat)
    failures = rules_kernel.check_frontier_invariants(lat, fr)
    n_calls = 0
    seen = set()
    for dtag, dtype, atol in _LATTICE_DTYPES:
        lp = _log_probs(lat, T, K, seed=7, dtype=dtype)
        scores, co, mk = _sausage_layout(lat, lp)
        own, dco, st, ok, fin = _dag_layout(lat, lp)
        lo = _loss_only_args(lat, lp)
        with capture_calls() as recs:
            fwd = sausage_forward(scores, co, mk)
            bwd = sausage_backward(scores, co, mk)
            s_lo = sausage_loss_only(*lo, lat.level_arcs, kappa=_KAPPA)
            d_fwd = dag_forward(own, dco, st, ok, fin, fr.pidx)
            d_bwd = dag_backward(own, dco, fin, ok, fr.sidx)
            d_lo = dag_loss_only(*lo, lat.is_start, lat.is_final,
                                 lat.level_arcs, fr.pidx, kappa=_KAPPA)
        failures.extend(f"[{dtag}] {f}" for f in tally.check(recs))
        n_calls += len(recs)
        seen.update(r.name for r in recs)
        pairs = [
            ("sausage_forward", fwd, ref.sausage_forward_ref(scores, co, mk),
             ("alpha", "c_alpha", "logZ", "c_avg")),
            ("sausage_backward", bwd,
             ref.sausage_backward_ref(scores, co, mk), ("beta", "c_beta")),
            ("sausage_loss_only", s_lo,
             ref.sausage_loss_only_ref(*lo, lat.level_arcs, kappa=_KAPPA),
             ("logZ", "c_avg")),
            ("dag_forward", d_fwd,
             ref.dag_forward_ref(own, dco, st, ok, fin, fr.pidx),
             ("alpha", "c_alpha", "logZ", "c_avg")),
            ("dag_backward", d_bwd,
             ref.dag_backward_ref(own, dco, fin, ok, fr.sidx),
             ("beta", "c_beta")),
            ("dag_loss_only", d_lo,
             ref.dag_loss_only_ref(*lo, lat.is_start, lat.is_final,
                                   lat.level_arcs, fr.pidx, kappa=_KAPPA),
             ("logZ", "c_avg")),
        ]
        for kname, got, want, labels in pairs:
            tag = f"{kname}[{dtag}]"
            failures += rules_kernel.check_finite(tag, got, labels=labels)
            failures += rules_kernel.diff_outputs(tag, got, want, atol=atol,
                                                  rtol=atol, labels=labels)
    facts = {"calls": n_calls, "kernels": sorted(seen),
             "frontier_shape": list(lat.level_arcs.shape)}
    return facts, failures


def _swa_inputs(rng, dtype, dev, shape=_SWA_SHAPE) -> dict:
    B, T, H, K, hd = shape
    shapes = {"q": (B, T, H, hd), "k": (B, T, K, hd), "v": (B, T, K, hd),
              "g": (B, T, H, hd), "tq": (B, T, H, hd), "tk": (B, T, K, hd),
              "tv": (B, T, K, hd)}
    return {n: torch.from_numpy(rng.normal(0.0, 1.0, s).astype(np.float32))
            .to(dev, dtype) for n, s in shapes.items()}


def _sanitize_vector_kernels(dev, tally: _Tally) -> Tuple[Dict, List[str]]:
    """The attention kernels (forward, vjp and jvp on the tensor-core and
    CUDA-core routes) and ``cg_fused_update`` at small shapes, f32 and
    bf16, then the tensor-core attention at hd 128 and 256: structure and
    oracle checks for the non-lattice kernels."""
    failures: List[str] = []
    rng = np.random.default_rng(3)
    n_calls = 0
    seen = set()
    w = _SWA_WINDOW
    for shape in _SWA_WIDE:
        dtag, atol = f"bf16 hd {shape[-1]}", _VECTOR_DTYPES[1][2]
        x = _swa_inputs(rng, BF16, dev, shape)
        q, k, v, g = x["q"], x["k"], x["v"], x["g"]
        tan = (x["tq"], x["tk"], x["tv"])
        with capture_calls() as recs:
            outs = [SWA.swa_attention(q, k, v, w),
                    *SWA.swa_attention_vjp(q, k, v, g, w),
                    SWA.swa_attention_jvp(q, k, v, *tan, w)]
        failures.extend(f"[{dtag}] {f}" for f in tally.check(recs))
        n_calls += len(recs)
        seen.update(r.name for r in recs)
        want = [ref.swa_attention_ref(q, k, v, w),
                *ref.swa_attention_vjp_ref(q, k, v, g, w),
                ref.swa_attention_jvp_ref(q, k, v, *tan, w)]
        labels = ["o", "dq", "dk", "dv", "to"]
        tag = f"swa_attention[{dtag}]"
        failures += rules_kernel.check_finite(tag, outs, labels=labels)
        failures += rules_kernel.diff_outputs(tag, outs, want, atol=atol,
                                              rtol=atol, labels=labels)
    for dtag, dtype, atol in _VECTOR_DTYPES:
        x = _swa_inputs(rng, dtype, dev)
        q, k, v, g = x["q"], x["k"], x["v"], x["g"]
        tan = (x["tq"], x["tk"], x["tv"])
        cg_in = [torch.from_numpy(rng.normal(0.0, 1.0, (_CG_N,))
                                  .astype(np.float32)).to(dev, dtype)
                 for _ in range(4)]
        with capture_calls() as recs:
            outs = {
                "swa_attention": [SWA.swa_attention(q, k, v, w)],
                "swa_attention_vjp": SWA.swa_attention_vjp(q, k, v, g, w),
                "swa_attention_jvp": [SWA.swa_attention_jvp(q, k, v, *tan,
                                                            w)],
                "cg_fused_update": cg_fused_update(0.25, *cg_in)}
            if dtype == BF16:     # the CUDA-core kernels at bf16 too
                outs["cuda_core_swa_attention"] = [
                    SWA.cuda_core_swa_attention(q, k, v, w)]
                outs["swa_attention_vjp(core)"] = SWA.swa_attention_vjp(
                    q, k, v, g, w, core=True)
                outs["swa_attention_jvp(core)"] = [SWA.swa_attention_jvp(
                    q, k, v, *tan, w, core=True)]
        failures.extend(f"[{dtag}] {f}" for f in tally.check(recs))
        n_calls += len(recs)
        seen.update(r.name for r in recs)
        fwd = ref.swa_attention_ref(q, k, v, w)
        vjp = ref.swa_attention_vjp_ref(q, k, v, g, w)
        jvp = ref.swa_attention_jvp_ref(q, k, v, *tan, w)
        want = {"swa_attention": ([fwd], ["o"]),
                "cuda_core_swa_attention": ([fwd], ["o"]),
                "swa_attention_vjp": (vjp, ["dq", "dk", "dv"]),
                "swa_attention_vjp(core)": (vjp, ["dq", "dk", "dv"]),
                "swa_attention_jvp": ([jvp], ["to"]),
                "swa_attention_jvp(core)": ([jvp], ["to"]),
                "cg_fused_update": (ref.cg_fused_update_ref(0.25, *cg_in),
                                    ["x", "r", "rr"])}
        for kname, got in outs.items():
            plain, labels = want[kname]
            tag = f"{kname}[{dtag}]"
            failures += rules_kernel.check_finite(tag, got, labels=labels)
            failures += rules_kernel.diff_outputs(tag, got, plain, atol=atol,
                                                  rtol=atol, labels=labels)
    return {"calls": n_calls, "kernels": sorted(seen)}, failures


def _branch_coverage(tally: _Tally) -> List[str]:
    """The launch configurations the sweep must have captured: every
    tensor-core attention launcher at hd_pad 64, 128 and 256, the DAG
    launchers with their state in global scratch and ``sausage_loss_only``
    with its slots spilled."""
    want = {**{(n, "hd_pad"): {64, 128, 256} for n in STEM_OF
               if n.endswith("_sm90_launch")},
            **{(n, "gstride"): None for n in STEM_OF if n.startswith("dag_")},
            ("sausage_loss_only_launch", "scratch"): {True}}
    out = []
    for (name, key), values in want.items():
        got = tally.ks001.get(name, {}).get(key, set())
        if values is None and not any(got) or values and values - got:
            out.append(f"{name} never ran with {key} "
                       f"{sorted(values) if values else '> 0'} (ran with "
                       f"{sorted(got)})")
    return out


def check_precision_flow(device="cuda") -> List[str]:
    """KS005 over every wrapper: bf16 inputs keep the lse sums and the
    <r, r> accumulator in f32 (the bf16 CG iterates stay bf16).  Each
    wrapper runs on small real tensors of ``device``."""
    dev = resolve_device(device)
    lat, T, K = corpus.padded_row_case(device=dev)
    fr = lattice_frontiers(lat)
    lp = _log_probs(lat, T, K, seed=5, dtype=BF16)
    lo = _loss_only_args(lat, lp)
    sc = torch.from_numpy(np.random.default_rng(5).normal(
        0.0, 1.0, (2, 3, 4)).astype(np.float32)).to(dev, BF16)
    own, co, st, ok, fin = [t.to(BF16) for t in _dag_layout(lat, lp)]
    four = [("alpha", F32), ("c_alpha", F32), ("logZ", F32), ("c_avg", F32)]
    two = [("logZ", F32), ("c_avg", F32)]
    checks = [
        ("sausage_forward[bf16]", sausage_forward, (sc, sc.abs()), four),
        ("sausage_backward[bf16]", sausage_backward, (sc, sc.abs()),
         [("beta", F32), ("c_beta", F32)]),
        ("dag_forward[bf16]", dag_forward, (own, co, st, ok, fin, fr.pidx),
         four),
        ("dag_backward[bf16]", dag_backward, (own, co, fin, ok, fr.sidx),
         [("beta", F32), ("c_beta", F32)]),
        ("sausage_loss_only[bf16]",
         functools.partial(sausage_loss_only, kappa=_KAPPA),
         lo + (lat.level_arcs,), two),
        ("dag_loss_only[bf16]",
         functools.partial(dag_loss_only, kappa=_KAPPA),
         lo + (lat.is_start, lat.is_final, lat.level_arcs, fr.pidx), two),
    ]
    v = torch.linspace(-1.0, 1.0, 64, device=dev).to(BF16)
    checks.append(("cg_fused_update[bf16]", cg_fused_update,
                   (0.5, v, v, v, v), [("x", BF16), ("r", BF16),
                                       ("rr", F32)]))
    qkv = torch.linspace(-1.0, 1.0, 16 * 64, device=dev).to(BF16) \
        .reshape(1, 16, 1, 64)
    checks.append(("swa_attention[bf16]",
                   functools.partial(SWA.swa_attention, window=8),
                   (qkv, qkv, qkv), [("o", BF16)]))
    failures: List[str] = []
    for name, fn, args, expected in checks:
        failures += rules_kernel.check_output_dtypes(name, fn, args,
                                                     expected)
    return failures


def card_facts() -> dict:
    """KS001's facts of the build on the card: {"static": {launcher:
    static shared bytes (ptxas)}, "dynamic": {(tensor-core launcher,
    hd_pad): dynamic shared bytes (the library)}}.  Builds the libraries
    if they are missing."""
    from repro_torch.kernels import build
    build.build_all()
    ptxas = {stem: rules_kernel.parse_ptxas(build.build_log(stem))
             for stem in set(STEM_OF.values())}
    static = {name: rules_kernel.static_smem(ptxas[stem], name)
              for name, stem in STEM_OF.items()}
    dynamic = {}
    for p in (64, 128, 256):
        dynamic[("swa_attention_sm90_launch", p)] = SWA.sm90_smem_bytes(p)
        for kind in ("dq", "dkdv", "jvp"):
            dynamic[(f"swa_attention_{kind}_sm90_launch", p)] = \
                SWA.sm90_bwd_smem_bytes(kind, p)
    return {"static": static, "dynamic": dynamic}


def run_sanitize(device="cuda") -> Tuple[Dict, List[str]]:
    """The full sanitizer on ``device``: the corpus pass, the vector
    kernels and the precision-flow audit.  Returns (report, failures);
    no failures means the kernel layer is clean."""
    dev = resolve_device(device)
    facts = card_facts() if dev.type == "cuda" else {}
    tally = _Tally(facts)
    report: Dict = {"device": str(dev), "cases": {}}
    failures: List[str] = []
    cases = {**corpus.ADVERSARIAL_CASES, **corpus.SPILL_CASES}
    for name in sorted(cases):
        case_facts, fs = _sanitize_case(name, cases[name], dev, tally)
        report["cases"][name] = case_facts
        failures.extend(f"[{name}] {f}" for f in fs)
    case_facts, fs = _sanitize_vector_kernels(dev, tally)
    report["cases"]["vector_kernels"] = case_facts
    failures.extend(f"[vector_kernels] {f}" for f in fs)
    missing = sorted(set(STEM_OF) - set(tally.launchers))
    if missing:
        failures.append(f"[coverage] launchers never run: {missing}")
    failures += [f"[coverage] {f}" for f in _branch_coverage(tally)]
    fs = check_precision_flow(dev)
    report["precision_flow_ok"] = not fs
    failures.extend(f"[precision] {f}" for f in fs)
    report.update(
        launches=dict(sorted(tally.launchers.items())),
        records=tally.records, build_launches=tally.build_launches,
        ks001={name: {k: sorted(v) for k, v in seen.items()}
               for name, seen in sorted(tally.ks001.items())},
        static_smem=facts.get("static", {}),
        failures=failures)
    return report, failures


# ---------------------------------------------------------------------------
# self-test: the seeded mutants must be flagged
# ---------------------------------------------------------------------------

def _load_fixture(name: str):
    path = FIXTURES_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"torch_sanitizer_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def self_test(device="cuda") -> List[str]:
    """Prove the sanitizer has teeth.  Returns the self-test's problems
    (none means it passed): the off-by-one frontier gather and the bf16
    loss-only sums must be flagged by KS003 and KS005.  That the real
    kernels come back clean is ``run_sanitize``'s to show; every caller
    runs it beside this."""
    dev = resolve_device(device)
    problems: List[str] = []

    # mutant 1: off-by-one frontier gather into the real dag_forward
    bad_gather = _load_fixture("bad_gather")
    lat, T, K = corpus.max_fanin_case(device=dev)
    fr = lattice_frontiers(lat)
    lp = _log_probs(lat, T, K, seed=11)
    own, co, st, ok, fin = _dag_layout(lat, lp)
    with capture_calls() as recs:
        try:
            bad_gather.bad_dag_forward(own, co, st, ok, fin, fr.pidx)
        except RuntimeError:
            # the plain version's gather checks its bounds on the CPU and
            # raises after the record was taken; the kernel on the card
            # runs on and reads the position as an empty slot
            if dev.type != "cpu":
                raise
    flagged = [f for r in recs for f in rules_kernel.check_gather_bounds(r)]
    if not any("KS003" in f for f in flagged):
        problems.append("self-test: the seeded off-by-one frontier gather "
                        "(fixtures/torch_sanitizer/bad_gather.py) was NOT "
                        "flagged by KS003")

    # mutant 2: loss-only sums cast back to bf16
    bad_precision = _load_fixture("bad_precision")
    lat2, T2, K2 = corpus.padded_row_case(device=dev)
    lp2 = _log_probs(lat2, T2, K2, seed=11, dtype=BF16)
    flagged = rules_kernel.check_output_dtypes(
        "bad_sausage_loss_only[bf16]",
        functools.partial(bad_precision.bad_sausage_loss_only,
                          kappa=_KAPPA),
        _loss_only_args(lat2, lp2) + (lat2.level_arcs,),
        [("logZ", F32), ("c_avg", F32)])
    if not any("KS005" in f for f in flagged):
        problems.append("self-test: the seeded bf16 loss-only sums "
                        "(fixtures/torch_sanitizer/bad_precision.py) were "
                        "NOT flagged by KS005")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.sanitize_kernels",
        description="the kernel sanitizer of the port's CUDA kernels "
                    "(rules: repro_torch.analysis.rules_kernel)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default): the kernels on the card; cpu: "
                    "the plain versions, with the launches they stand for")
    ap.add_argument("--report", default=None,
                    help="write the sanitizer's facts to this JSON path")
    ap.add_argument("--self-test", action="store_true",
                    help="also require the seeded mutant fixtures to be "
                    "flagged")
    args = ap.parse_args(argv)
    report, failures = run_sanitize(args.device)
    problems: List[str] = []
    if args.self_test:
        problems = self_test(args.device)
        report["self_test_problems"] = problems
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True, default=str)
    for f in failures + problems:
        print(f"FAIL {f}")
    print(f"kernel sanitizer on {report['device']}: {len(failures)} "
          f"failures over {len(report['cases'])} cases ({report['records']} "
          f"captured launches, {report['build_launches']} on the card; "
          f"{len(report['launches'])} launchers)"
          + (f", self-test {'ok' if not problems else 'FAIL'}"
             if args.self_test else ""))
    return 1 if (failures or problems) else 0


if __name__ == "__main__":
    sys.exit(main())
