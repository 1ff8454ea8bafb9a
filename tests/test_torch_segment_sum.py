"""Kernel K1, the sorted CSR segment-sum (kgc_gcn_torch/ops/segment_sum.py),
on the CPU: its plain version against the TPU kernel in interpret mode
(kgc_gcn_tpu/ops/spmm_pallas.py:segment_sum_pallas) and against
jax.ops.segment_sum.  The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py, on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgc_gcn_tpu.ops.spmm_pallas import segment_sum_pallas

from kgc_gcn_torch.ops.segment_sum import segment_sum

# exact comparisons: dyadic messages, see test_torch_cuda.py (they are also
# exact through the TPU kernel's hi/lo bf16 split of float32 messages)
from test_torch_cuda import ATOL, RTOL, case_counts, csr_case


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(case_counts()))
def test_plain_matches_pallas_and_jax_segment_sum(case, dtype):
    counts, d = case_counts()[case]
    n_rows = len(counts)
    msg, dst, indptr = csr_case(counts, d, seed=1)
    jmsg = jnp.asarray(msg).astype(dtype)
    # the TPU kernel cannot take E = 0 (its edge tiles are sliced from the
    # messages): that case is held against jax.ops.segment_sum alone
    want_pallas = None if len(dst) == 0 else np.asarray(segment_sum_pallas(
        jmsg, jnp.asarray(dst), jnp.asarray(indptr), n_rows, interpret=True))
    want_xla = np.asarray(jax.ops.segment_sum(
        jmsg.astype(jnp.float32), jnp.asarray(dst), num_segments=n_rows))

    tmsg = torch.from_numpy(msg).to(getattr(torch, dtype))
    before = segment_sum.launches
    got = segment_sum(tmsg, torch.from_numpy(dst), torch.from_numpy(indptr),
                      n_rows)
    assert segment_sum.launches == before        # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (n_rows, d)
    got = got.numpy()
    np.testing.assert_allclose(got, want_xla, rtol=RTOL, atol=ATOL)
    if want_pallas is not None:
        np.testing.assert_allclose(got, want_pallas, rtol=RTOL, atol=ATOL)
    assert not got[np.asarray(counts) == 0].any()   # empty rows are zeros


def test_wrapper_rejects_bad_inputs():
    msg, dst, indptr = csr_case([1, 0, 2, 1], 3, seed=2)
    t = lambda a: torch.from_numpy(a)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        segment_sum(t(msg).double(), t(dst), t(indptr), 4)
    with pytest.raises(ValueError, match="dst"):
        segment_sum(t(msg), t(dst).long(), t(indptr), 4)
    with pytest.raises(ValueError, match="indptr"):
        segment_sum(t(msg), t(dst), t(indptr), 5)
    bad = indptr.copy()
    bad[-1] = len(dst) + 1
    with pytest.raises(ValueError, match="edge count"):
        segment_sum(t(msg), t(dst), t(bad), 4)
