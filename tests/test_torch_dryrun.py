"""The port's dry-run (``repro_torch.launch.dryrun``) on torch's fake
process group, on the CPU: fake-world traces of one step.

* per-rank honesty: on a fake 2 × 2 world one rank's FLOPs × 4 lie within
  [0.95, 1.25] of the unsharded count (llama3.2-1b at its published widths
  and depth, B 4 × T 256; ``FlopCounterMode``'s mixed DTensor / local
  total gives 0.99 × 4 there), and a train step with microbatches, remat
  and AdamW (rwkv6-7b's smoke config: the WKV operator under ``local_map``
  and autograd) within the same band;
* the collectives a trace counts by kind: output bytes, an all-reduce
  twice, functional and in-place;
* ``run_cell`` for llama3.2-1b's ``decode_32k`` over 256 fake ranks:
  status, terms and memory, the JSON record saved; ``should_skip``;
* ``run_cell`` for llama3.2-1b's ``prefill_32k`` over 256 fake ranks: a
  rank's traced peak below one layer's dense (T, T) float32 scores on that
  rank (the blockwise attention keeps none);
* ``shard_params`` under ``FakeTensorMode`` reads no fake data pointer.
"""
import json
import warnings

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.roofline import COLLECTIVES, StepTrace
from repro_torch.models.config import ShapeCell


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: tier-1 runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _per_rank_ratio(cfg, cell, **kw) -> tuple:
    """(one rank's FLOPs × 4 / the unsharded FLOPs, the rank's report) on
    a fake 2 × 2 world."""
    one, *_ = dryrun.trace_cell(cfg, cell, None, "cpu", **kw)
    with dryrun.fake_world(4):
        mesh = make_local_mesh(2, device_type="cpu")
        rank, *_ = dryrun.trace_cell(cfg, cell, mesh, "cpu",
                                     mesh_desc="2x2", **kw)
    return 4 * rank.flops_per_device / one.flops_per_device, rank, one


def test_per_rank_flops_are_one_ranks_share():
    ratio, rank, one = _per_rank_ratio(get_config("llama3.2-1b"),
                                       ShapeCell("t", 256, 4, "prefill"))
    assert 0.95 <= ratio <= 1.25, ratio
    # FSDP x TP: a rank holds a quarter of the weights
    ma, ma1 = rank.memory_analysis, one.memory_analysis
    assert 0.24 <= ma["params_bytes"] / ma1["params_bytes"] <= 0.26
    assert rank.coll_breakdown["all-gather"] > 0
    assert rank.coll_breakdown["all-reduce"] > 0
    assert one.coll_bytes_per_device == 0


def test_sharded_train_step_traces_one_ranks_share():
    """The train step on the fake world: microbatches split within each
    data shard, gradients accumulated in shards like their parameters,
    the vocab-sharded loss, the remat recompute inside the mesh's
    replication scope, the WKV operator's shapes and FLOP formula on each
    rank's heads, AdamW on the shards."""
    ratio, rank, _ = _per_rank_ratio(get_smoke_config("rwkv6-7b"),
                                     ShapeCell("t", 32, 8, "train"),
                                     microbatches=2, opt_state_dtype=None)
    assert 0.95 <= ratio <= 1.25, ratio
    ma = rank.memory_analysis
    assert ma["opt_state_bytes"] >= 2 * ma["params_bytes"] > 0
    assert rank.coll_breakdown["reduce-scatter"] > 0


def test_collectives_counted_by_kind():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(4):
        group = dist.group.WORLD
        with FakeTensorMode():
            t = torch.empty((8, 4))                  # 128 bytes
            with StepTrace() as trace:
                # under a fake mode the functional ones wait at once
                funcol.all_gather_tensor(t, 0, group)
                funcol.all_reduce(t, "sum", group)
                funcol.reduce_scatter_tensor(t, "sum", 0, group)
                funcol.all_to_all_single(t, None, None, group)
                dist.all_reduce(t)                   # in place (c10d)
    assert trace.coll == {"all-gather": 4 * 128, "all-reduce": 2 * 2 * 128,
                          "reduce-scatter": 128 // 4, "all-to-all": 128,
                          "collective-permute": 0}
    assert tuple(trace.coll) == COLLECTIVES
    assert trace.flops == 0


def test_run_cell_decode_on_256_fake_ranks(tmp_path):
    rec = dryrun.run_cell("llama3.2-1b", "decode_32k", False,
                          device="cpu", save_dir=str(tmp_path),
                          verbose=False)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["mesh"] == "pod16x16" and rec["device"] == "cpu"
    for k in ("t_compute", "t_memory", "t_collective", "flops_per_device",
              "bytes_per_device", "coll_bytes_per_device", "useful_ratio"):
        assert rec[k] > 0, k
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    ma = rec["memory_analysis"]
    # the caches as the port holds them (replicated) and as the rules
    # would shard them
    assert ma["caches_bytes"] > 200 * ma["caches_sharded_bytes"] > 0
    assert ma["peak_size_in_bytes"] >= ma["argument_size_in_bytes"]
    saved = json.loads((tmp_path / "llama3_2-1b__decode_32k__pod16x16.json")
                       .read_text())
    assert saved == json.loads(json.dumps(rec))
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_run_cell_prefill_32k_keeps_no_score_tensor():
    rec = dryrun.run_cell("llama3.2-1b", "prefill_32k", False,
                          device="cpu", verbose=False)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    cfg = get_config("llama3.2-1b")
    # a rank's batch rows (data 16 of 32) and every query head (8 kv
    # heads do not divide the 16-way model dim: heads replicated)
    b_local, T = 32 // 16, 32_768
    dense_scores = b_local * cfg.n_heads * T * T * 4
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] < ma["peak_size_in_bytes"] \
        < dense_scores, (ma, dense_scores)


def test_should_skip_long_context_on_full_attention():
    cell = ShapeCell("long_500k", 524_288, 1, "decode")
    assert "sub-quadratic" in dryrun.should_skip(get_config("llama3.2-1b"),
                                                 cell)
    assert dryrun.should_skip(get_config("rwkv6-7b"), cell) is None
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", False, device="cpu",
                          verbose=False)
    assert rec["status"] == dryrun.SKIP


def test_shard_params_reads_no_fake_data_pointer():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.steps import model_state_shapes
    from repro_torch.parallel import sharding as sh
    fake = FakeTensorMode()
    params, _ = model_state_shapes(get_smoke_config("llama3.2-1b"),
                                   opt_state_dtype=None, device="cpu",
                                   fake_mode=fake)
    with dryrun.fake_world(4):
        mesh = make_local_mesh(2, device_type="cpu")
        with fake, warnings.catch_warnings():
            warnings.simplefilter("error")
            sharded = sh.shard_params(params, mesh)
    wq = sharded["blocks"]["layer0"]["mixer"]["wq"]
    # a dim-0 shard is its own storage, not a view of the whole
    loc = wq.to_local()
    assert loc.untyped_storage().nbytes() == loc.numel() * loc.element_size()
