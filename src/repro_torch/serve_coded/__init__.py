"""repro_torch.serve_coded — coded computation as the inference server's
policy (the port of ``repro.serve_coded``).

The bridge (:class:`CodedServingBridge`) serves real prefill/decode token
generation (``repro_torch.launch.serve`` model stack) where the large
matmuls of every token batch are MDS-coded tasks planned by the streaming
machinery (``repro_torch.stream``): the OnlinePlanner's (k, b, l) allocation picks the
worker shards, the SharePool enforces the paper's column-sum ≤ 1 ledger
across tenants' concurrent steps, and a pluggable admission policy
("fifo" | "edf" | "fair") arbitrates which waiting requests join a batch.
The port serves ``coding_scope="head"`` — the output head — in this
slice; decoded outputs are exact: greedy tokens are bit-identical to the
uncoded pipeline.
"""
from .bridge import (CODING_SCOPES, EXECUTION_MODES, CodedServingBridge,
                     ServeReport, default_pool)
from .coded_linear import (CodedLinear, CodedLMHead, HeadStep, LinearStep,
                           PrefixPlan, prefix_plan_batch, shard_products)
from .packing import PackedShards, PackedStage, ShardProblem
from .plan_cache import StepPlan, StepPlanCache
from .requests import ServeRequest, synthetic_requests

__all__ = [
    "CodedServingBridge", "ServeReport", "default_pool", "CODING_SCOPES",
    "EXECUTION_MODES",
    "CodedLMHead", "HeadStep", "CodedLinear", "LinearStep", "PrefixPlan",
    "prefix_plan_batch", "shard_products",
    "PackedShards", "PackedStage", "ShardProblem",
    "StepPlan", "StepPlanCache",
    "ServeRequest", "synthetic_requests",
    "serve_policy_sweep", "print_policy_table", "run_coded_smoke",
    "write_trace_summary",
]


def serve_policy_sweep(bridge: CodedServingBridge, requests, policies,
                       churn=()):
    """Serve the same workload once per admission policy on one bridge.

    The model, jitted step functions and encoded layers are
    policy-independent, so only the admission config swaps between runs —
    the columns of the resulting reports are directly comparable.  With the
    bridge's ``verify`` on, each run is asserted to decode every coded
    matmul to the uncoded product (within the backend's tolerance).
    """
    from ..stream.queueing import AdmissionConfig
    reports = {}
    for policy in policies:
        bridge.admission = AdmissionConfig(policy=policy)
        rep = bridge.serve(requests, churn=churn)
        if rep.decode_ok is not None:
            assert rep.decode_ok, (
                f"{policy}: coded decode diverged from the uncoded "
                f"pipeline (max_err={rep.max_err:.2e}, "
                f"match={rep.argmax_match_rate:.3f})")
        assert rep.tokens_generated > 0 and len(rep.steps) > 0
        reports[policy] = rep
    return reports


def print_policy_table(reports) -> None:
    """One row per admission policy: throughput, sojourn tail, misses."""
    print(f"{'policy':<7} {'tok/sim-s':>10} {'p50 ms':>9} {'p99 ms':>9} "
          f"{'miss%':>6} {'waste':>6} {'steps':>6} {'solves':>6} "
          f"{'max_err':>9}")
    for policy, rep in reports.items():
        s = rep.summary()
        print(f"{policy:<7} {s['tokens_per_sim_second']:10.1f} "
              f"{s.get('sojourn_p50', float('nan')):9.1f} "
              f"{s.get('sojourn_p99', float('nan')):9.1f} "
              f"{100.0 * s.get('deadline_miss_rate', 0.0):6.1f} "
              f"{s.get('wasted_fraction', 0.0):6.2f} "
              f"{len(rep.steps):6d} {rep.solve_steps:6d} "
              f"{rep.max_err:9.2e}")


def write_trace_summary(tracer, path, verbose: bool = True) -> None:
    """Write ``tracer``'s Chrome/Perfetto trace to ``path`` and print a
    one-line per-stage wall breakdown (load the file in
    https://ui.perfetto.dev to browse the spans)."""
    tracer.write(path)
    if verbose:
        s = tracer.summary()
        stages = "  ".join(f"{k}={v * 1e3:.1f}ms"
                           for k, v in s["per_stage_wall"].items())
        cov = s["stage_coverage"]
        print(f"[trace] {path}: {s['span_count']} spans, {stages}, "
              f"stage coverage "
              f"{'n/a' if cov is None else format(cov, '.3f')}")


def run_coded_smoke(*, arch: str = "llama3.2-1b", smoke: bool = True,
                    policies=("fifo", "edf", "fair"),
                    n_requests: int = 12, prompt_len: int = 16,
                    gen_len: int = 8, masters: int = 2,
                    slots_per_master: int = 3, rate: float = 0.004,
                    coding_scope: str = "head",
                    steps_per_dispatch: int = 1,
                    execution: str = "batched",
                    backend: str = "torch", seed: int = 0,
                    trace=None, faults=None, ls_tail: bool = False,
                    verbose: bool = True, device=None):
    """Serve one synthetic workload under each admission policy.

    Returns 0 on success (CLI-friendly); asserts that every decoded coded
    matmul matched the uncoded product.  The model and the ``"torch"``
    backend run on ``device`` (default ``cuda``).  ``trace`` writes
    a Chrome/Perfetto trace of the whole sweep (every policy's serve, as
    sibling "serve" spans) to that path.  ``faults`` (a fault spec string
    or :class:`repro_torch.faults.FaultConfig`) arms the chaos layer —
    injected crash/drop/stale/corrupt faults are detected, localised and
    recovered during the serve, and a per-policy fault summary prints
    after the table.  ``ls_tail`` routes every decode through the
    stacked-LS tail (bit-identical at exactly L rows).
    """
    if isinstance(faults, str):
        from ..faults import parse_fault_spec
        faults = parse_fault_spec(faults)
    tracer = None
    if trace:
        from ..obs import Tracer
        tracer = Tracer(meta={"entry": "run_coded_smoke", "arch": arch,
                              "scope": coding_scope, "backend": backend,
                              "execution": execution,
                              "device": str(device)})
    from ..stream import AdmissionConfig, StreamConfig
    bridge = CodedServingBridge(
        masters=masters, arch=arch, smoke=smoke, backend=backend,
        config=StreamConfig(admission=AdmissionConfig(policy="edf"),
                            rng=seed),
        slots_per_master=slots_per_master, coding_scope=coding_scope,
        steps_per_dispatch=steps_per_dispatch, execution=execution,
        faults=faults, ls_tail=ls_tail, tracer=tracer, device=device)
    bridge._setup_model(prompt_len + gen_len + 8)
    reqs = synthetic_requests(
        n_requests, masters=masters, vocab=bridge._model["cfg"].vocab,
        prompt_len=prompt_len, gen_len=gen_len, rate=rate, seed=seed)
    reports = serve_policy_sweep(bridge, reqs, policies)
    if verbose:
        print(f"[serve_coded] arch={arch} requests={n_requests} "
              f"gen={gen_len} masters={masters} "
              f"slots/master={slots_per_master} scope={coding_scope} "
              f"steps/dispatch={steps_per_dispatch} "
              f"execution={execution} backend={backend}")
        print_policy_table(reports)
        if faults is not None:
            for policy, rep in reports.items():
                f = rep.faults or {}
                print(f"[faults] {policy}: injected={f.get('injected', 0):.0f} "
                      f"detection={f.get('detection_rate', 1.0):.3f} "
                      f"localization={f.get('localization_rate', 1.0):.3f} "
                      f"quarantines={f.get('quarantines', 0):.0f} "
                      f"readmissions={f.get('readmissions', 0):.0f} "
                      f"retries={f.get('retries', 0):.0f} "
                      f"modes={rep.decode_modes}")
        print("[serve_coded] all decoded coded matmuls matched the uncoded "
              "pipeline")
    if tracer is not None:
        write_trace_summary(tracer, trace, verbose)
    return 0
