"""The metric arithmetic on hand-worked inputs: percentiles, the busy
union, the overlap, and the MSM and NTT work counts."""

import pytest

from zkbench.metrics import msm_roofline_pct, ntt_roofline_pct
from zkbench.metrics.prove_overlap_pct import open_at_least
from zkbench.peaks import FQ_PRODUCT, FR_PRODUCT, HBM_BYTES_S, IMAD_S
from zkbench.stats import percentile, spread
from zkbench.trace import Kernel, Span, Trace, busy_us, merged


def test_percentile_over_all_requests():
    values = list(range(1, 11))            # 1..10
    assert percentile(values, 90) == pytest.approx(9.1)
    assert percentile(values, 50) == pytest.approx(5.5)
    assert percentile([4.0], 90) == 4.0
    assert percentile(list(reversed(values)), 90) == pytest.approx(9.1)


def test_spread():
    # quartiles of 1..8 by the exclusive method: 2.25 and 6.75; median 4.5
    assert spread(range(1, 9)) == pytest.approx(4.5 / 4.5)
    assert spread([10.0] * 6) == 0.0


def test_busy_union():
    assert busy_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert busy_us([(5, 6), (0, 10)]) == 10
    assert busy_us([]) == 0
    assert merged([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def span(start, end, tid=1, kind="prove", desc=""):
    return Span(kind, desc, start, end, (tid, tid + 100, -tid + 3))


def test_overlap():
    spans = [span(0, 4), span(2, 6, tid=2), span(7, 8)]
    assert open_at_least(spans, 2, 0, 10) == 2
    assert open_at_least(spans, 1, 0, 10) == 7
    assert open_at_least(spans, 2, 3, 10) == 1


def test_msm_count_hand_worked():
    # N = 2^10: without the endomorphism the best is c = 8, 32 windows
    # of (1024 + 256) = 40,960; with it (127 bits over 2,048 points) c = 8
    # gives 16 * (2048 + 256) = 36,864, and nothing is fewer
    assert msm_roofline_pct.least_adds(1 << 10) == 36864
    n = 1 << 20
    adds = msm_roofline_pct.least_adds(n)
    assert adds == 17301504              # c = 16: 8 * (2^21 + 2^16)
    assert msm_roofline_pct.least_msm_seconds(n) == pytest.approx(
        max(adds * 6 * FQ_PRODUCT / IMAD_S, n * 128 / HBM_BYTES_S))


def test_ntt_count_hand_worked():
    n, rows = 1 << 20, 3
    ops = rows * (n // 2) * 20 * FR_PRODUCT
    nbytes = 2 * rows * n * 32
    assert ntt_roofline_pct.least_ntt_seconds(n, rows) == pytest.approx(
        max(ops / IMAD_S, nbytes / HBM_BYTES_S))
    assert ntt_roofline_pct.least_ntt_seconds(1 << 18, 1) < \
        ntt_roofline_pct.least_ntt_seconds(1 << 19, 1)


class _Run:
    def __init__(self, trace):
        self.trace = trace


def test_trace_readers_hand_worked():
    # two MSM spans on two threads; kernels launched inside and outside
    spans = {"msm": [span(0.0, 1.0, tid=7, kind="msm", desc="1024"),
                     span(0.5, 1.5, tid=8, kind="msm", desc="1024")]}
    kernels = [Kernel("a", 1.0, 1.2, 0.2, 7),     # in thread 7's span
               Kernel("b", 1.2, 1.6, 1.2, 108),   # in thread 8's, by ident
               Kernel("e", 1.6, 1.6, 0.7, -5),    # thread 8's, signed
               Kernel("c", 1.6, 1.7, 1.8, 7),     # after every span
               Kernel("d", 1.7, 1.8, 0.6, 9)]     # another thread
    tr = Trace(start=0.0, end=2.0, proofs=2, kernels=kernels,
               device=[(k.start, k.end) for k in kernels], spans=spans,
               samples=[(0.5, "host work")])
    assert [k.name for k in tr.kernels_in("msm")] == ["a", "b", "e"]
    assert tr.busy_s() == pytest.approx(0.8)
    from zkbench.metrics import (device_idle_pct, launches_per_proof,
                                 msm_ms_per_proof)
    run = _Run(tr)
    assert device_idle_pct.read(run) == pytest.approx(60.0)
    assert launches_per_proof.read(run) == 2.5
    assert msm_ms_per_proof.read(run) == pytest.approx(300.0)
    least = 2 * msm_roofline_pct.least_msm_seconds(1024)
    assert msm_roofline_pct.read(run) == pytest.approx(100 * least / 0.6)
    assert ntt_roofline_pct.read(run) is None     # no NTT spans: nothing
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps == {"host work": pytest.approx(1.0),
                    "no host sample": pytest.approx(0.2)}
    assert tr.breakdown()["device_ops"][0][0] == "b"


def test_a_reused_thread_is_found_by_its_first_id():
    # a second pool's thread (native id 9) reuses the first's pthread_self
    # (low bits 50); the trace names both by the first one's id, 7
    spans = {"msm": [Span("msm", "8", 0.0, 1.0, (7, 50, 50)),
                     Span("msm", "8", 2.0, 3.0, (9, 50, 50))]}
    kernels = [Kernel("a", 0.5, 0.6, 0.5, 7), Kernel("b", 2.5, 2.6, 2.5, 7),
               Kernel("c", 1.5, 1.6, 1.5, 7)]
    tr = Trace(start=0.0, end=3.0, proofs=2, kernels=kernels,
               device=[(k.start, k.end) for k in kernels], spans=spans,
               samples=[])
    assert [k.name for k in tr.kernels_in("msm")] == ["a", "b"]


def test_readers_without_a_trace_read_nothing():
    from zkbench.metrics import (device_idle_pct, launches_per_proof,
                                 msm_ms_per_proof, prove_overlap_pct)
    for mod in (device_idle_pct, launches_per_proof, msm_ms_per_proof,
                msm_roofline_pct, ntt_roofline_pct, prove_overlap_pct):
        assert mod.read(_Run(None)) is None


def test_rooflines_count_only_spans_with_kernels():
    spans = {"ntt": [span(0.0, 1.0, tid=7, kind="ntt", desc="1024x1"),
                     span(2.0, 3.0, tid=7, kind="ntt", desc="1024x1")],
             "msm": [span(0.0, 1.0, tid=7, kind="msm", desc="1024"),
                     span(2.0, 3.0, tid=7, kind="msm", desc="1024")]}
    kernels = [Kernel("k", 1.0, 1.5, 0.5, 7)]    # in the first spans only
    tr = Trace(start=0.0, end=3.0, proofs=1, kernels=kernels,
               device=[(1.0, 1.5)], spans=spans, samples=[])
    found = tr.kernels_by_span("ntt")
    assert [len(ks) for _, ks in found] == [1, 0]
    run = _Run(tr)
    assert ntt_roofline_pct.read(run) == pytest.approx(
        100 * ntt_roofline_pct.least_ntt_seconds(1024, 1) / 0.5)
    assert msm_roofline_pct.read(run) == pytest.approx(
        100 * msm_roofline_pct.least_msm_seconds(1024) / 0.5)


def test_a_span_takes_its_times_from_its_annotation():
    # the span lasted 10 us on the host clock; the trace's own record of
    # it (100 us, on the launches' clock) holds the launch 50 us in
    from zkbench.trace import Tracer

    class Sampler:
        samples = []

    tracer = Tracer([], scratch=".")
    tracer._sampler = Sampler()
    tracer.calls = {0: (10.0, 11.0)}
    tracer.proofs = 1
    tracer.spans = [Span("ntt", "1024x1", 10.2, 10.20001, (5, 50, 50),
                         mark=0),
                    Span("ntt", "1024x1", 10.5, 10.50001, (5, 50, 50),
                         mark=1)]
    off = 1000.0                                  # trace us - host us
    events = [
        {"cat": "user_annotation", "name": "zkb.call|0",
         "ts": 10.0e6 + off, "dur": 1e6, "tid": 5},
        {"cat": "user_annotation", "name": "zkb.span|0",
         "ts": 10.2e6 + off - 20, "dur": 100, "tid": 5},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 10.2e6 + off + 50, "dur": 5, "tid": 5,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "ntt_pass", "ts": 10.2e6 + off + 60,
         "dur": 40, "tid": 7, "args": {"correlation": 1}},
    ]
    tr = tracer._trace(events)
    first, second = tr.spans["ntt"]
    assert first.exact and not second.exact       # no record of the second
    assert first.start == pytest.approx(10.2 - 20e-6)
    assert first.end == pytest.approx(10.2 + 80e-6)
    assert [(sp.mark, len(ks)) for sp, ks in tr.kernels_by_span("ntt")] == \
        [(0, 1), (1, 0)]
