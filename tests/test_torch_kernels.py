"""The kernel library's ptxas report, read back on the CPU (no build)."""

from pathlib import Path

from aes_zero_knowledge_proof_circuit_tpu_torch import kernels

# the shape of `nvcc -Xptxas -v` output for two sources, kernels in an
# anonymous namespace (whose mangled name carries the file's hash)
REPORT = """== msm.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__203575b8_6_msm_cu_044e45c418segment_accumulateEPKjPKiPKhPKxS7_xPj' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__203575b8_6_msm_cu_044e45c418segment_accumulateEPKjPKiPKhPKxS7_xPj
    20 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 24576 bytes smem
ptxas info    : Compiling entry function '_ZN38_GLOBAL__N__203575b8_6_msm_cu_044e45c413window_ladderEPKjiiPj' for 'sm_90a'
ptxas info    : Function properties for _ZN38_GLOBAL__N__203575b8_6_msm_cu_044e45c413window_ladderEPKjiiPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers
== ntt.cu
ptxas info    : Compiling entry function '_Z9ntt_stagePjPKjxxx' for 'sm_90a'
ptxas info    : Function properties for _Z9ntt_stagePjPKjxxx
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
"""


class _Lib:
    def __init__(self, path: Path):
        self.path = path


def test_resource_usage_reads_the_report(tmp_path, monkeypatch):
    so = tmp_path / "libzkaes_kernels_0.so"
    monkeypatch.setattr(kernels, "_LIB", _Lib(so))
    assert kernels.resource_usage() == []          # no report beside it
    kernels._ptxas_log(so).write_text(REPORT)
    assert kernels.resource_usage() == [
        ("msm.cu", "segment_accumulate", 128, 20, 20),
        ("msm.cu", "window_ladder", 255, 0, 0),
        ("ntt.cu", "ntt_stage", 40, 0, 0),
    ]


def test_demangle_leaves_plain_names():
    assert kernels._demangle("zk_msm_g1") == "zk_msm_g1"
