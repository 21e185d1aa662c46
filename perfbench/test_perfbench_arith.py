"""The yardstick's arithmetic against hand-worked shapes, and the trace
reader on a hand-made trace."""
import pytest

from perfbench import flops, readers
from perfbench.trace import TraceView

GPT2M = {"n_layers": 24, "d_model": 1024, "n_heads": 16, "n_kv_heads": 16,
         "d_head": 64, "d_ff": 4096, "vocab": 50257, "positions": "learned",
         "max_pos": 1024, "act": "gelu_tanh", "norm": "layer"}


def test_k1_least_operations_takes_the_cheaper_order():
    # fused: 2*4*(2*4*3 + 8*4*3) = 960; K1's own: 384 + 384 = 768
    assert flops.k1_operation_count(1, 4, 2, 1, 8, 4, 3) == 768
    assert flops.k1_least_operations(1, 4, 2, 1, 8, 4, 3) == 768
    # L1 = L2 = 1: the fused order, 2*(12 + 96) = 216, beats 192 + 48
    assert flops.k1_least_operations(1, 1, 1, 1, 8, 4, 3) == 216


def test_k2_least_operations():
    # prod 2*2*8*4*3 = 384, blend 2*4*2*8*3 = 384; without dW, U given:
    # own = blend + dB + blend = 1152; fused = 1*2*4*8*4*3 + 2*2*4*2*4*3
    assert flops.k2_operation_count(1, 4, 2, 1, 8, 4, 3, u_given=True,
                                    need_dW=False) == 1152
    assert flops.k2_least_operations(1, 4, 2, 1, 8, 4, 3, u_given=True,
                                     need_dW=False) == min(1152, 768 + 384)


def test_kernel_call_seconds_of_a_k1_call():
    dims = [[2, 24, 12], [4096, 3072], [2, 12, 1, 3072, 1024], []]
    types = ["float", "c10::BFloat16", "c10::BFloat16", "Scalar"]
    ops = flops.k1_least_operations(2, 24, 12, 1, 4096, 3072, 1024)
    nbytes = (4 * 2 * 24 * 12 + 2 * 4096 * 3072 + 2 * 2 * 12 * 3072 * 1024
              + 2 * 2 * 24 * 4096 * 1024)
    assert flops.kernel_call_bound("repro_torch::ligo_blend_expand_grouped",
                                   dims, types) == (ops, nbytes)
    assert flops.kernel_call_seconds(
        "repro_torch::ligo_blend_expand_grouped", dims, types) == \
        pytest.approx(max(ops / 989e12, nbytes / 3.35e12))
    assert flops.kernel_call_bound("repro_torch::other", dims, types) is None


def test_model_step_ops_of_gpt2_medium():
    n = 24 * (2 * 1024 * 1024 + 2 * 1024 * 1024 + 2 * 1024 * 4096) \
        + 50257 * 1024
    assert flops.matmul_params(GPT2M) == n == 353453056
    assert flops.model_step_ops(GPT2M, 8, 1024) == \
        6 * n * 8192 + 6 * 24 * 1024 * 1024 * 8192


def test_fewest_grow_order():
    # (L1=2, 3x5) -> (L2=4, 6x7): out, in, blend = 420 + 504 + 672
    assert flops._fewest(2, 4, 3, 5, 6, 7, True) == 1596
    assert flops._fewest(1, 1, 10, 4, None, 8, False) == 2 * 10 * 4 * 8


def _view():
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::einsum", "tid": 1,
         "ts": 0, "dur": 50, "args": {"External id": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::bmm", "tid": 1,
         "ts": 5, "dur": 10, "args": {"External id": 2}},
        {"ph": "X", "cat": "cpu_op", "tid": 1, "ts": 100, "dur": 100,
         "name": "repro_torch::ligo_blend_expand_grouped",
         "args": {"External id": 3,
                  "Input Dims": [[1, 4, 2], [8, 4], [1, 2, 1, 4, 3], []],
                  "Input type": ["float", "c10::BFloat16", "c10::BFloat16",
                                 "Scalar"]}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "tid": 1,
         "ts": 110, "dur": 5, "args": {"External id": 4}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "tid": 1,
         "ts": 300, "dur": 600, "args": {"External id": 5}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 120, "dur": 2, "args": {"correlation": 77}},
        {"ph": "X", "cat": "kernel", "name": "bmm_kernel", "tid": 7,
         "ts": 20, "dur": 100, "args": {"External id": 2}},
        {"ph": "X", "cat": "kernel", "name": "ligo_wgmma_gemm_kernel<3>",
         "tid": 7, "ts": 200, "dur": 50, "args": {"correlation": 77}},
        {"ph": "X", "cat": "kernel", "name": "k1_blend_kernel", "tid": 7,
         "ts": 900, "dur": 100, "args": {"External id": 3}},
    ]
    return TraceView(ev, 1e-3)


def test_trace_view_reads_busy_owner_and_breakdown():
    v = _view()
    assert v.busy_s() == pytest.approx(250e-6)
    total, by_op = v.kernel_time_under(readers.K1_OPS)
    # the launch without an External id found its op by its correlation
    assert total == pytest.approx(150e-6) and len(by_op) == 1
    assert v.device_ops() == [
        ["repro_torch::ligo_blend_expand_grouped", pytest.approx(150e-6)],
        ["aten::einsum", pytest.approx(100e-6)]]
    gaps = v.idle_gaps()
    assert gaps[0] == ["aten::item before k1_blend_kernel",
                       pytest.approx(650e-6)]


def test_readers_on_the_hand_made_trace():
    v = _view()
    run = readers.TracedRun(v, v, steps=2, step_ops=989e12 * 1e-3 / 4,
                            timed_steps=2, timed_wall_s=1e-3)
    least = max(768 / 989e12, (4 * 8 + 2 * 32 + 2 * 24 + 2 * 96) / 3.35e12)
    assert readers.kernel_roofline(run, readers.K1_OPS) == \
        pytest.approx(100 * least / 150e-6)
    assert readers.kernel_roofline(run, readers.K2_OPS) is None
    assert readers.mfu(run) == pytest.approx(50.0)
    assert readers.idle(run) == pytest.approx(75.0)
    assert readers.launches(run) == 1.5


def test_device_only_trace_names_gaps_by_the_runtime_call():
    """A trace of the device alone has no host ops: a gap is named by the
    runtime call in flight on the launching thread, and the readers that
    need ops (the rooflines) read the trace with shapes instead."""
    ev = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 0, "dur": 2, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "tid": 1, "ts": 10, "dur": 490, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 600, "dur": 2, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "a", "tid": 7, "ts": 5,
         "dur": 100, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "b", "tid": 7, "ts": 605,
         "dur": 100, "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memset", "name": "m", "tid": 7, "ts": 300,
         "dur": 10, "args": {}},
    ]
    v = TraceView(ev, 1e-3)
    assert v.ops == [] and v.busy_s() == pytest.approx(210e-6)
    gaps = v.idle_gaps()
    # the 295 us before b: the host waited in a sync; the 195 us before
    # the fill: no launch ties it to a thread
    assert gaps == [["cudaStreamSynchronize before b",
                     pytest.approx(295e-6)],
                    ["(host outside any traced op or call) before m",
                     pytest.approx(195e-6)]]
    run = readers.TracedRun(v, _view(), steps=2, step_ops=1.0,
                            timed_steps=0, timed_wall_s=0.0)
    assert readers.idle(run) == pytest.approx(79.0)
    assert readers.launches(run) == 1.0
    assert readers.kernel_roofline(run, readers.K1_OPS) is not None
    assert readers.mfu(run) is None          # no untraced window
