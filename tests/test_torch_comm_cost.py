"""The dry-run's collective term and a chip's share (repro_torch/launch:
``comm_cost``, ``op_cost``'s layouts, ``roofline``'s link model), on
cases worked out by hand.

* One stacked leaf ``[2, 64, 128]`` on ``{"data": 2, "model": 4}`` in
  train: its spec ``('data', 'model', None)``, its gathers, its
  reduce-scatter, the all-reduces of its product, and the product's
  FLOPs on one chip.
* An MoE layer's dispatch and combine all-to-alls; none where the
  experts do not divide ``model``.
* A decode cache split over ``model``: each attention layer's
  all-reduce of its partial output and softmax statistics.
* A leaf its spec leaves whole over ``model`` is gathered as one
  ``model`` shard's part; a tied table once a step.
* A 1×1 mesh moves nothing and a chip's counts are the step's own; the
  count's shares add up to its global counts.
* The link model: every group of 16×16 and 2×16×16 on InfiniBand, every
  group of 2×4 and 1×8 on NVLink.
* ``fsdp`` mode moves the batch over every axis, as ``AxisNames`` does.
* The layouts: heads hinted over ``model`` split the attention, a weight
  gradient takes its leaf's layout, a split of a merged dimension gives
  each axis back to its own dimension (GQA's kv groups too).
* A product of a replicated weight and activation is split over its
  output features only at the residual width; a hint on a product's
  output lays out the product too.
* A mamba scan's per-step gathers and reductions (rule 7), times the
  sequence, train and prefill; none where ``model`` does not divide
  ``d_state``, none in decode.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import comm_cost as cc
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import roofline as rl

MESH = {"data": 2, "model": 4}
PATH = "layers/0/pos0/mlp/w_gate"
STACKED = (2, 64, 128)


def _meta(*shape, dtype=torch.float32, grad=False):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.requires_grad_(grad)


def test_stacked_leaf_by_hand():
    # quirk 12: the rule's (fsdp, model) lands one axis early
    assert shd.param_pspec(PATH, STACKED, MESH) == ("data", "model", None)
    leaves = [(PATH, STACKED, STACKED[1:])]
    out = cc.CommCounts()
    # forward and backward: 2 uses of each of its 2 periods, each period
    # gathered over data (its period axis) as 64 × 128 / 4 bf16 elements
    cc.param_gathers(leaves, MESH, torch.bfloat16, {PATH: 2}, out)
    assert dict(out.bytes) == {("all-gather", ("data",)):
                               2 * 2 * 64 * 128 // 4 * 2}
    out = cc.CommCounts()
    # the float32 gradient scattered to its shard: 2·64·128 / (2·4)
    cc.grad_reductions(leaves, MESH, out)
    assert dict(out.bytes) == {("reduce-scatter", ("data",)):
                               2 * 64 * 128 // 8 * 4}

    # its product with a batch of 8 × 32 tokens, float32: the
    # contraction (d) lies over model
    w = _meta(64, 128)
    x = _meta(8, 32, 64)
    seeds = {w: op_cost.param_layout(PATH, STACKED, (64, 128)),
             x: op_cost.Layout(op_cost.dims_of(x.shape, ("batch",)))}
    counts = op_cost.count_ops(lambda x, w: x @ w, x, w, seeds=seeds)
    flops, _, _ = op_cost.per_chip(counts, MESH)
    assert counts.flops == 2 * 256 * 64 * 128
    assert flops == counts.flops / 8          # batch 2 × model 4
    out = cc.CommCounts()
    cc.tp_reductions(counts.products, MESH, True, out)
    # the output on one chip, 128 tokens × 128 features, and in the
    # backward the input's gradient, 128 × 64
    assert dict(out.bytes) == {("all-reduce", ("model",)):
                               128 * 128 * 4 + 128 * 64 * 4}
    out = cc.CommCounts()
    cc.tp_reductions(counts.products, MESH, False, out)
    assert out.total == 128 * 128 * 4
    # 1×8: no batch split, 256 tokens a chip
    out = cc.CommCounts()
    cc.tp_reductions(counts.products, {"data": 1, "model": 8}, False, out)
    assert out.total == 256 * 128 * 4


def test_leaf_whole_over_model_gathers_a_model_shard_by_hand():
    # wo [periods, H, D, d] and w_down [periods, ff, d] carry no model:
    # each use gathers over data the part one model shard reads, as the
    # reference's compiled olmo-1b steps do on 2×4 (f32[1,16,64] and
    # f32[128,16] a layer)
    wo, w_down = ("layers/0/pos0/attn/wo", (2, 4, 16, 64)), \
        ("layers/0/pos0/mlp/w_down", (2, 128, 64))
    assert shd.param_pspec(*wo, MESH) == (None, None, "data", None)
    assert shd.param_pspec(*w_down, MESH) == (None, "data", None)
    out = cc.CommCounts()
    cc.param_gathers([(p, s, s[1:]) for p, s in (wo, w_down)], MESH,
                     torch.float32, {}, out)
    assert dict(out.bytes) == {("all-gather", ("data",)):
                               2 * (4 * 16 * 64 + 128 * 64) // 4 * 4}
    # a tied table is gathered once a step: by the lookup and the logits
    cfg = reduced(get_config("olmo-1b"))
    assert cfg.tie_embeddings and cfg.vocab_size == 256
    table = ("embed/table", (256, 64), (256, 64))
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(kind, 32, 8, kind)
        counts = dryrun.count_step(cfg, shape, 2)
        whole = cc.plan_collectives(cfg, shape, MESH, counts, groups=2)
        out = cc.CommCounts()
        cc.param_gathers([table], MESH, torch.float32, {}, out)
        assert out.total == 256 * 64 // 4 * 4
        assert whole.bytes[("all-gather", ("data",))] >= out.total


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-236b",
                                  "qwen2-0.5b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_shares_add_up_to_the_global_counts(arch, kind):
    # hints move a buffer's counts from one class to another
    # (``OpCounter._hint``); they neither make nor lose any
    cfg = reduced(get_config(arch))
    counts = dryrun.count_step(cfg, ShapeConfig(kind, 32, 8, kind), 2)
    totals = (counts.flops, counts.bytes, counts.transcendentals)
    assert counts.flops > 0 and counts.bytes > 0
    for k in range(3):
        assert math.fsum(s[k] for s in counts.shares.values()) \
            == pytest.approx(totals[k], rel=1e-12)
        assert min(s[k] for s in counts.shares.values()) \
            >= -1e-12 * totals[k]
    # and one chip of a 1×1 mesh does all of it
    assert op_cost.per_chip(counts, {"data": 1, "model": 1}) \
        == pytest.approx(totals, rel=1e-12)


def test_moe_all_to_alls_by_hand():
    cfg = reduced(get_config("deepseek-v2-236b"))
    # 256 tokens in 2 groups of 128; capacity ceil(128·2·1.25/4) = 80;
    # the buffer [2, 4, 80, 64] float32, one group and one expert a chip
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model) == (4, 2, 64)
    per_chip = 1 * 1 * 80 * 64 * 4
    for train, n in ((False, 2), (True, 4)):
        out = cc.CommCounts()
        cc.expert_dispatch(cfg, 256, 2, MESH, train, torch.float32, out)
        # one MoE layer (layer 0 is dense)
        assert dict(out.bytes) == {("all-to-all", ("model",)):
                                   n * per_chip}
    out = cc.CommCounts()          # 4 experts do not divide 8
    cc.expert_dispatch(cfg, 256, 1, {"data": 1, "model": 8}, True,
                       torch.float32, out)
    assert out.total == 0
    out = cc.CommCounts()          # a dense family has none
    cc.expert_dispatch(reduced(get_config("olmo-1b")), 256, 2, MESH, True,
                       torch.float32, out)
    assert out.total == 0


def test_split_decode_by_hand():
    cfg = reduced(get_config("olmo-1b"))
    att = cfg.attention
    assert (att.n_heads, att.head_dim, cfg.num_layers) == (4, 16, 2)
    # the cache [periods, B, S, Hkv, D] has its sequence over model
    spec = shd.state_pspecs(cfg, MESH, 8, 32)["caches.0.k"]
    assert spec[2] == "model"
    out = cc.CommCounts()
    cc.split_decode(cfg, 8, 32, MESH, out)
    # 4 sequences a chip × 4 heads × (16 outputs + max + sum), float32,
    # in each of 2 layers
    assert dict(out.bytes) == {("all-reduce", ("model",)):
                               2 * 4 * 4 * (16 + 2) * 4}
    out = cc.CommCounts()          # a cache of 8 slots is not split
    cc.split_decode(cfg, 8, 8, MESH, out)
    assert out.total == 0


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_chip_moves_nothing(arch, kind):
    cfg = reduced(get_config(arch))
    shape = ShapeConfig(kind, 32, 4, kind)
    mesh = {"data": 1, "model": 1}
    counts = dryrun.count_step(cfg, shape, 1)
    comm = cc.plan_collectives(cfg, shape, mesh, counts)
    assert comm.total == 0 and not any(comm.by_kind.values())
    assert op_cost.per_chip(counts, mesh) == pytest.approx(
        (counts.flops, counts.bytes, counts.transcendentals), rel=1e-12)
    # and a real mesh moves something
    assert cc.plan_collectives(cfg, shape, MESH, counts,
                               groups=2).total > 0


def test_link_model():
    axes_of = {"16x16": [("data",), ("model",), ("data", "model")],
               "2x16x16": [("pod",), ("data",), ("model",),
                           ("pod", "data")],
               "2x4": [("data",), ("model",), ("data", "model")],
               "1x8": [("model",), ("data", "model")]}
    meshes = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16},
              "2x4": {"data": 2, "model": 4},
              "1x8": {"data": 1, "model": 8}}
    for name, mesh in meshes.items():
        ib = name in ("16x16", "2x16x16")
        for axes in axes_of[name]:
            assert rl.crosses_nodes(mesh, axes) == ib, (name, axes)
            assert rl.link_bandwidth(mesh, axes) \
                == (rl.IB_BW if ib else rl.NVLINK_BW)
    # 4×4: a model group is 4 neighbours, a data group strides 4 apart
    mesh = {"data": 4, "model": 4}
    assert not rl.crosses_nodes(mesh, ("model",))
    assert rl.crosses_nodes(mesh, ("data",))
    assert (rl.NVLINK_BW, rl.IB_BW) == (450e9, 50e9)


def test_collective_time_is_bytes_over_link():
    comm = cc.CommCounts()
    comm.add("all-gather", ("data",), 1e9)
    comm.add("all-reduce", ("model",), 2e9)
    nbytes, secs = rl.collective_terms(comm, {"data": 16, "model": 16})
    assert nbytes == {"data": 1e9, "model": 2e9}
    assert sum(secs.values()) == pytest.approx(3e9 / rl.IB_BW)
    _, secs = rl.collective_terms(comm, {"data": 2, "model": 4})
    assert sum(secs.values()) == pytest.approx(3e9 / rl.NVLINK_BW)


def test_fsdp_mode_moves_the_batch_over_every_axis(monkeypatch):
    assert shd.AxisNames(MESH, "fsdp").batch == ("data", "model")
    assert shd.AxisNames(MESH, "hybrid").batch == "data"
    assert dryrun.num_token_groups(MESH, "fsdp") == 8
    assert dryrun.num_token_groups(MESH, "hybrid") == 2
    batch_only = (frozenset({8}), frozenset(), None)
    assert op_cost.share_divisor(batch_only, MESH, "hybrid") == 2
    assert op_cost.share_divisor(batch_only, MESH, "fsdp") == 8
    # model is the batch's already: an op is not split over it twice
    both = (frozenset({8}), frozenset({64}), None)
    assert op_cost.share_divisor(both, MESH, "hybrid") == 8
    assert op_cost.share_divisor(both, MESH, "fsdp") == 8
    # a batch model does not divide splits over the model axis alone
    assert op_cost.share_divisor((frozenset({2}), frozenset({64}), None),
                                 MESH, "fsdp") == 4
    # no tensor-parallel reductions; gradients scatter over both axes
    cfg = reduced(get_config("olmo-1b"))
    shape = ShapeConfig("train", 32, 8, "train")
    counts = dryrun.count_step(cfg, shape, 8)
    out = cc.CommCounts()
    cc.tp_reductions(counts.products, MESH, True, out, "fsdp")
    assert out.total == 0
    out = cc.CommCounts()
    cc.grad_reductions([(PATH, STACKED, STACKED[1:])], MESH, out, "fsdp")
    assert dict(out.bytes) == {("reduce-scatter", ("data", "model")):
                               2 * 64 * 128 // 8 * 4}
    monkeypatch.setenv("REPRO_SHARDING_MODE", "fsdp")
    assert dryrun.num_token_groups(MESH) == 8


def test_param_layout_and_leaf_shards():
    lay = op_cost.param_layout("layers/0/pos0/attn/wq", (2, 64, 4, 16),
                               (64, 4, 16))
    assert lay.dims == (frozenset({("model", 64)}), frozenset(),
                        frozenset())
    assert lay.leaf == ("layers/0/pos0/attn/wq", (2, 64, 4, 16))
    # the optimiser on a leaf alone: all of its spec's shards
    assert op_cost.share_divisor((frozenset(), frozenset(), lay.leaf),
                                 MESH) == 8
    norm = ("final_norm/scale", (64,))
    assert op_cost.share_divisor((frozenset(), frozenset(), norm),
                                 MESH) == 1


def test_heads_hint_splits_attention_scores():
    q = _meta(8, 32, 4, 16)
    k = _meta(8, 32, 4, 16)
    seeds = {t: op_cost.Layout(op_cost.dims_of(t.shape, ("batch",)))
             for t in (q, k)}

    def scores(q, k):
        q, k = (shd.hint(t, "batch", None, "model", None) for t in (q, k))
        return torch.einsum("bqhd,bkhd->bhqk", q, k)

    counts = op_cost.count_ops(scores, q, k, seeds=seeds)
    assert counts.by_op["bmm"] == 2 * 8 * 4 * 32 * 32 * 16
    # every op (the product and einsum's copies) over batch 2 × 4 heads
    # on 2×4; 4 heads do not divide 8, so over the batch alone on 2×8
    assert op_cost.per_chip(counts, MESH)[0] == counts.flops / 8
    assert op_cost.per_chip(counts, {"data": 2, "model": 8})[0] \
        == counts.flops / 2
    # outside a count, hint is the identity
    assert shd.hint(q, "batch", None, "model", None) is q


def test_weight_gradient_takes_its_leaf_layout():
    w = _meta(64, 128, grad=True)
    x = _meta(8, 32, 64)
    lay = op_cost.param_layout(PATH, STACKED, (64, 128))
    seeds = {w: lay, x: op_cost.Layout(op_cost.dims_of(x.shape,
                                                        ("batch",)))}
    with op_cost.OpCounter(seeds) as counter:
        g, = torch.autograd.grad((x @ w).sum(), [w])
    assert counter.layouts[g].leaf == lay.leaf
    assert counter.layouts[g].dims == lay.dims
    # the weight gradient's product is split as the forward's: 2·256·64·128
    # FLOPs each, over batch 2 × model 4
    flops, _, _ = op_cost.per_chip(counter.counts, MESH)
    assert sum(counter.counts.by_op.values()) == 2 * (2 * 256 * 64 * 128)
    assert flops <= counter.counts.flops / 8 + 256 * 128


def test_split_of_a_merged_dimension():
    b, m = frozenset({("batch", 8)}), frozenset({("model", 4)})
    # [B·H, S, D] back to [B, H, S, D]: each axis to its own dimension
    dims = op_cost._reshape((32, 16, 8), (b | m, frozenset(), frozenset()),
                            (8, 4, 16, 8))
    assert dims == (b, m, frozenset(), frozenset())
    # a merge keeps them on the merged dimension
    assert op_cost._reshape((8, 4, 16), (b, m, frozenset()), (32, 16)) \
        == (b | m, frozenset())
    # GQA's [B·Hkv, ...] back to [B, Hkv, ...]: 4 heads in 2 kv groups,
    # no dimension of size 4, so the heads take the one the batch left
    dims = op_cost._reshape((16, 64, 32), (b | m, frozenset(), frozenset()),
                            (8, 2, 64, 32))
    assert dims == (b, m, frozenset(), frozenset())


def test_plan_collectives_rows_carry_the_term():
    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), remat="block")
    shape = ShapeConfig("train", 32, 8, "train")
    row = dryrun.lower_cell("olmo-1b", shape, mesh=MESH, cfg=cfg)
    coll = row["collectives"]
    assert set(coll) == set(cc.KINDS)
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0 \
        and coll["all-reduce"] > 0
    assert sum(row["collectives_by_axes"].values()) == pytest.approx(
        sum(coll.values()))
    assert row["t_collective_s"] == pytest.approx(
        sum(coll.values()) / rl.NVLINK_BW)


@pytest.mark.parametrize("width,split", [(64, True), (128, False)])
def test_output_split_only_at_the_residual_width(width, split):
    # a weight with no model entry ("mlstm/wq" lands its model on the
    # period axis of one period) and an activation with none
    w = _meta(64, width)
    x = _meta(8, 32, 64)
    lay = op_cost.param_layout("layers/0/pos0/mlstm/wq", (1, 64, width),
                               (64, width))
    assert not any(lay.dims)
    seeds = {w: lay, x: op_cost.Layout(op_cost.dims_of(x.shape,
                                                        ("batch",)))}
    counts = op_cost.count_ops(lambda x, w: x @ w, x, w, seeds=seeds,
                               residual=64)
    flops, _, _ = op_cost.per_chip(counts, MESH)
    # 2·256·64·width FLOPs, over batch 2 and, at the residual width,
    # over model 4 on the output features
    assert counts.flops == 2 * 256 * 64 * width
    assert flops == counts.flops / (8 if split else 2)


def test_hint_on_a_product_lays_out_the_product():
    w = _meta(64, 128)
    x = _meta(8, 32, 64)
    lay = op_cost.param_layout("layers/0/pos0/mlstm/wq", (1, 64, 128),
                               (64, 128))
    seeds = {w: lay, x: op_cost.Layout(op_cost.dims_of(x.shape,
                                                        ("batch",)))}

    def proj(x, w):
        return shd.hint((x @ w).unflatten(-1, (2, 64)), "batch", None,
                        None, "model")

    counts = op_cost.count_ops(proj, x, w, seeds=seeds, residual=64)
    # replicated over model as made, split by the hint on its view: the
    # product's FLOPs over batch 2 × model 4, and no reshard
    assert op_cost.per_chip(counts, MESH)[0] == counts.flops / 8
    assert not counts.reshards


@pytest.mark.parametrize("kind,gathers,reduces", [("train", 5, 3),
                                                   ("prefill", 2, 1)])
def test_recurrence_steps_by_hand(kind, gathers, reduces):
    cfg = reduced(get_config("jamba-v0.1-52b"))
    leaves = cc._leaves(dryrun.abstract_model(cfg))
    mamba = [l for l in leaves if l[0].endswith("mamba/A_log")]
    di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    assert len(mamba) == 7 and all(l[1] == (1, di, N) for l in mamba)
    out = cc.CommCounts()
    cc.recurrence_steps(leaves, 8, 32, MESH, kind == "train", out)
    # 7 layers × 32 steps, each [B/2 = 4, di] float32 over model
    unit = 4 * di * 4 * 32 * 7
    assert dict(out.bytes) == {("all-gather", ("model",)): gathers * unit,
                               ("all-reduce", ("model",)): reduces * unit}
    # d_state 8 does not divide over model 16: the state is not split
    out = cc.CommCounts()
    cc.recurrence_steps(leaves, 8, 32, {"data": 1, "model": 16},
                        True, out)
    assert not out.bytes


def test_decode_runs_no_time_loop(monkeypatch):
    calls = []
    monkeypatch.setattr(cc, "recurrence_steps",
                        lambda *a, **k: calls.append(a[2]))
    cfg = reduced(get_config("jamba-v0.1-52b"))
    for kind in ("train", "prefill", "decode"):
        cc.plan_collectives(cfg, ShapeConfig(kind, 32, 8, kind), MESH,
                            op_cost.OpCounts())
    # the sequence's trip count for train and prefill; a decode step has
    # no loop
    assert calls == [32, 32]
