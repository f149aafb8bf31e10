"""The port's dry run (``repro_torch.launch.dryrun``) on small fake worlds.

* The reference's ``test_debug_mesh_dryrun_smoke`` cell (deepseek-moe-16b
  reduced to 3 layers in bf16, train_4k cut to 8 x 64, 2 microbatches) on
  a 2 x 4 mesh: status ok, argument bytes the sum of the ranks' local
  shards, per-rank flops (one microbatch traced, times 2) equal to a hand
  count of the step's products, collectives recorded.
* A dense reduced cell whose every product is counted by hand from the
  Megatron layout (one head, a quarter of d_ff and of the vocab a rank).
* Counting below DTensor: one (1024, 8192) x (8192, 29568) product over a
  fake 16 x 16 world counts the rank's local product, not the logical one
  (``FlopCounterMode`` above DTensor counts the logical one).
* A small ``--lanns`` cell: status ok, argument bytes, and flops equal to
  the route projection plus K1's scores over every segment.
"""

import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

from repro_torch.configs.families import get_arch
from repro_torch.launch import dryrun as dr


@pytest.fixture(autouse=True)
def _world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _local_sum(args):
    from torch.distributed.tensor import DTensor

    n = 0
    for t in dr._flat_args(args):
        t = t._local_tensor if isinstance(t, DTensor) else t
        n += t.numel() * t.element_size()
    return n


def _lm_cell(arch_id, n_layers, dtype, remat):
    arch = copy.copy(get_arch(arch_id))
    red = arch.model_config(reduced=True)
    arch._config = dataclasses.replace(red, n_layers=n_layers, param_dtype=dtype,
                                       compute_dtype=dtype)
    if not remat:
        base = arch._dryrun_model_cfg
        arch._dryrun_model_cfg = lambda cell: dataclasses.replace(base(cell), remat=False)
    arch.num_micro = 2
    cell = dataclasses.replace(arch.cells["train_4k"], global_batch=8, seq_len=64)
    return arch, cell


def _block_flops(T, d, qkv_cols, o_rows, ff, B, H, S, hd):
    """One block's forward products on a rank: q, k, v, the two attention
    products, o, and the SwiGLU's three."""
    return (2 * T * d * qkv_cols + 2 * (2 * B * H * S * S * hd) + 2 * T * o_rows * d
            + 2 * (2 * T * d * ff) + 2 * T * ff * d)


def test_dense_cell_flops_are_the_hand_count():
    """codeqwen reduced (d 64, 4 heads of 16, d_ff 128, vocab 512, 2
    layers), no remat, 8 x 64 tokens, 2 microbatches, on 2 x 4: a rank's
    microbatch is 2 rows of 64 tokens, one head, 32 of d_ff, 128 of the
    vocab; the backward is twice the forward."""
    arch, cell = _lm_cell("codeqwen1.5-7b", 2, "float32", remat=False)
    rec = dr.run_cell("codeqwen1.5-7b", "train_4k", mesh="2x4", arch=arch, cell=cell)
    assert rec["status"] == "ok", rec.get("traceback")
    T, d, B_loc, S, hd = 128, 64, 2, 64, 16
    fwd = 2 * _block_flops(T, d, 3 * hd, hd, 32, B_loc, 1, S, hd) + 2 * T * d * 128
    assert rec["cost"]["flops"] == 2 * (3 * fwd)  # 2 microbatches x (fwd + 2 fwd)


def test_debug_mesh_dryrun_smoke():
    """The reference's debug-mesh cell: status ok; argument bytes the sum
    of the local shards; flops the hand count of its products (expert
    products at the capacity's slots, remat's recompute of each block)."""
    arch, cell = _lm_cell("deepseek-moe-16b", 3, "bfloat16", remat=True)
    rec = dr.run_cell("deepseek-moe-16b", "train_4k", mesh="2x4", arch=arch, cell=cell)
    assert rec["status"] == "ok", rec.get("traceback")
    spec = arch.build_cell(cell, dr.mesh_for(mesh="2x4")[0])
    assert rec["memory"]["argument_bytes"] == _local_sum(spec.args)
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["num_micro"] == 2 and rec["traced_microbatches"] == 1
    # hand count: d 64, 4 heads of 16 (one a rank), dense d_ff 128 (32 a
    # rank), 8 experts of d_ff 64, top-2 (2 a rank; capacity 8.0 gives
    # C = T), one shared expert of 64 (16 a rank), vocab 512 (128 a rank)
    T, d, B_loc, S, hd = 128, 64, 2, 64, 16
    attn = 2 * T * d * 3 * hd + 2 * (2 * B_loc * S * S * hd) + 2 * T * hd * d
    dense = attn + 2 * (2 * T * d * 32) + 2 * T * 32 * d
    router = 2 * T * d * 8
    moe = attn + router + 3 * (2 * 2 * T * d * 64) + 3 * (2 * T * d * 16)
    blocks = dense + 2 * moe
    head = 2 * T * d * 128
    fwd = blocks + head
    # remat recomputes every block's forward but its last product (the
    # MLP's or the shared expert's down projection: no backward reads its
    # output, and torch's non-reentrant checkpoint stops once the saved
    # tensors are back); the backward is twice the forward
    last = 2 * T * 32 * d + 2 * (2 * T * 16 * d)
    per_micro = fwd + (blocks - last) + 2 * fwd
    assert rec["cost"]["flops"] == 2 * per_micro


def test_rank_counts_its_local_product_not_the_logical_one():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh = dr.fake_mesh((16, 16), ("data", "model"))
    mode = FakeTensorMode()
    with mode:
        x = distribute_tensor(torch.empty(1024, 8192, dtype=torch.bfloat16), mesh,
                              [Shard(0), Shard(1)], src_data_rank=None)
        w = distribute_tensor(torch.empty(8192, 29568, dtype=torch.bfloat16), mesh,
                              [Shard(0), Shard(1)], src_data_rank=None)
    rec = dr.trace(lambda a, b: a @ b, (x, w), mode)
    assert rec["cost"]["flops"] < 2 * 1024 * 8192 * 29568 / 100
    assert rec["cost"]["flops"] == 2 * 1024 * 512 * 1848
    assert rec["memory"]["argument_bytes"] == (64 * 512 + 512 * 1848) * 2


def test_lanns_cell_is_ok_with_its_hand_count():
    rec = dr.run_lanns_cell(mesh="2x4", corpus_n=80_000, dim=16, batch_per_device=8,
                            num_segments=4, topk=10)
    assert rec["status"] == "ok", rec.get("traceback")
    S, m, D, B = 4, 4, 16, 8
    n_seg = int(np.ceil(80_000 / S / m / 8)) * 8
    C = rec["capacity"]
    args_bytes = B * D * 4 + m * n_seg * (D * 4 + 4 + 4) + (m - 1) * (D + 3) * 4
    assert rec["memory"]["argument_bytes"] == args_bytes
    assert rec["cost"]["flops"] == 2 * B * D * (m - 1) + m * 2 * C * n_seg * D
    assert rec["collectives"]["all-gather"]["count"] > 0
