"""The benchmark's one hook into the program's calls: a pass-through
wrapper around ``TensorScheduler.precompute`` (the device feasibility
precompute every path here reaches; disruption calls it from
``disruption/prefix.py``) and ``TensorScheduler.build_problem``.

It keeps what the check and the per-layer metrics read: each precompute's
shapes, host interval and, while a pass is being kept for the check, its
groups, problem and fetched outputs. With tracing on, each precompute also
runs inside a ``bench.precompute`` profiler range, so the device work it
launched can be told apart in the trace."""

from __future__ import annotations

import contextlib
import time


def shapes(problem) -> dict:
    """G, M, T, N, K, W, R, O, Z of a precompute's problem: G groups, M
    templates, T types and N nodes (0 without) over K keys of W words, R
    resources, O offerings a type, Z zones."""
    G, K, W = problem.group_enc.mask.shape
    has_exist = (problem.exist_enc is not None
                 and problem.exist_enc.mask.shape[0] > 0)
    return dict(G=G, M=problem.template_enc.mask.shape[0],
                T=problem.it_enc.mask.shape[0],
                N=problem.exist_avail.shape[0] if has_exist else 0,
                K=K, W=W, R=problem.group_req.shape[1],
                O=problem.off_zone.shape[1], Z=problem.zone_values.shape[0])


class Probe:
    """Records of the precompute calls of the current pass."""

    def __init__(self):
        self.calls: list = []        # {shape, start, end} of this pass
        self.keep = False            # keep problem, groups and outputs
        self.profiling = False       # mark each call for the profiler
        self._groups = None

    def new_pass(self, keep: bool) -> None:
        """Start a pass: a new record list, kept in full when ``keep``."""
        self.calls = []
        self.keep = keep

    @contextlib.contextmanager
    def installed(self):
        from karpenter_tpu_torch.provisioning.tensor_scheduler import \
            TensorScheduler
        precompute = TensorScheduler.precompute
        build_problem = TensorScheduler.build_problem
        probe = self

        def build_problem_kept(ts, groups):
            out = build_problem(ts, groups)
            # (problem, templates, catalog): the catalog gives the type order
            probe._groups = (groups, out[2]) if probe.keep else None
            return out

        def precompute_kept(ts, problem):
            rng = contextlib.nullcontext()
            if probe.profiling:
                import torch
                rng = torch.profiler.record_function("bench.precompute")
            start = time.perf_counter()
            with rng:
                tensors = precompute(ts, problem)
            rec = {"shape": shapes(problem), "start": start,
                   "end": time.perf_counter()}
            if probe.keep:
                groups, catalog = probe._groups or (None, None)
                rec.update(problem=problem, tensors=tensors, groups=groups,
                           catalog=catalog)
            probe.calls.append(rec)
            return tensors

        TensorScheduler.build_problem = build_problem_kept
        TensorScheduler.precompute = precompute_kept
        try:
            yield self
        finally:
            TensorScheduler.build_problem = build_problem
            TensorScheduler.precompute = precompute
