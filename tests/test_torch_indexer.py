"""The port's indexer: the 9 index commitments, made on the 8-bit bucket
scan (ops/msm_device.py, plain K4 version here), and the slot layout equal
the host indexer's, on the toy circuit and on the u32 add circuit. The JAX
package builds the circuit and the SRS; `convert` carries them across."""


import pytest

from aes_zero_knowledge_proof_circuit_tpu.marlin import indexer
from aes_zero_knowledge_proof_circuit_tpu.models.ops_demo import build_u32_add
from aes_zero_knowledge_proof_circuit_tpu_torch import convert
from aes_zero_knowledge_proof_circuit_tpu_torch.marlin import indexer as tindexer
from tests.torch_threads import jax_srs, one_torch_thread  # noqa: F401


def toy_circuit():
    from tests.test_marlin import build_toy_circuit

    return build_toy_circuit()[0]


@pytest.mark.parametrize("build", [toy_circuit, lambda: build_u32_add()[0]],
                         ids=["toy", "u32_add"])
def test_index_commitments_equal_host(build):
    cs = build()
    na, nb, nc = cs.nnz()
    need = indexer.required_degree(cs.num_constraints, cs.num_variables,
                                   max(na, nb, nc))
    srs = jax_srs(need, 5)
    want = indexer.index(cs, srs)
    got = tindexer.index(convert.r1cs_from(cs), convert.srs_from(srs), "cpu")
    xy = lambda p: None if p.inf else (int(p.x), int(p.y))
    assert [xy(c.point) for c in got.vk.index_comms] == [
        xy(c.point) for c in want.vk.index_comms]
    assert tindexer.required_degree(cs.num_constraints, cs.num_variables,
                                    max(na, nb, nc)) == need
    assert got.var_to_slot == want.var_to_slot
    assert (got.log_n, got.log_x, got.vk.log_ks) == (
        want.log_n, want.log_x, want.vk.log_ks)
    for gm, wm in zip(got.matrices, want.matrices):
        assert list(gm.row_slots) == list(wm.row_slots)
        assert list(gm.col_slots) == list(wm.col_slots)
