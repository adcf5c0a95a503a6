"""The port's dry-run (repro_torch/launch) against the JAX reference.

* ``input_specs``, ``decode_specs`` (through the stacked layout) and
  ``abstract_params`` have the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s for all ten configs × their shapes;
  ``sharding.state_leaves`` names the port's decode state as it is.
* ``model_flops_for`` equals the reference's.
* The counter: a Python loop of 10 matmuls counts 10× one (the port's
  ``test_scan_equals_unroll_flops``); a batched matmul counts
  2·B·M·N·K; a reduced dense forward counts the matmul FLOPs of a
  formula written from the code; pointwise ops count one FLOP an
  element, transcendentals apart; views move no bytes.
* ``lower_cell`` on a reduced config of each family, train, prefill and
  decode: ``status`` ok, finite terms, ``t_collective`` positive on 2×2
  and 0 on 1×1, where a chip's counts are the step's own.
* ``render`` of fixed rows equals the reference's ``render``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs, shapes_for
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro.launch import specs as ref_specs
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun, report, roofline, specs
from repro_torch.launch.op_cost import count_ops
from repro_torch.models import model as M
from repro_torch.models.transformer import build_segments
from repro_torch.train.optimizer import AdamWConfig


def _dt(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return np.dtype(x).name


def _same(t: torch.Tensor, ref, shape=None):
    return (tuple(t.shape) == tuple(shape if shape is not None
                                    else ref.shape)
            and _dt(t.dtype) == _dt(ref.dtype))


@pytest.mark.parametrize("arch", list_archs())
def test_input_and_decode_specs_match_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    model = specs.abstract_model(cfg)
    for shape in shapes_for(ref_cfg):
        if shape.kind != "decode":
            want = ref_specs.input_specs(ref_cfg, shape)
            got = specs.input_specs(cfg, shape)
            assert set(got) == set(want), shape.name
            assert all(v.device.type == "meta" for v in got.values())
            for k in want:
                assert _same(got[k], want[k]), (shape.name, k)
            continue
        ref_tok, ref_state = ref_specs.decode_specs(ref_cfg, shape)
        tok, state = specs.decode_specs(cfg, shape, model)
        assert _same(tok, ref_tok)
        layer, leaves = 0, {}
        for si, seg in enumerate(build_segments(cfg)):
            for _ in range(seg.n_periods):
                for j in range(len(seg.period)):
                    rc = ref_state["caches"][si][f"pos{j}"]
                    pc = state.caches[layer]
                    for f in pc._fields:
                        t = getattr(pc, f)
                        want_shape = getattr(rc, f).shape[1:]
                        if f in ("k", "v"):   # [B, Hkv, S, D] ← [B, S, Hkv, D]
                            t = t.transpose(1, 2)
                        assert _same(t, getattr(rc, f), want_shape), \
                            (shape.name, layer, f)
                        leaves[f"caches.{layer}.{f}"] = getattr(rc, f).shape
                    layer += 1
        assert layer == len(state.caches)
        assert state.pos.shape == () and state.pos.dtype == torch.int32
        for f in ("enc_out", "enc_pos"):
            if f in ref_state:
                assert _same(getattr(state, f), ref_state[f])
                leaves[f] = ref_state[f].shape
            else:
                assert getattr(state, f) is None
        # the plans' view of the state is the state as it is
        named = {n: s for n, _, s, _ in
                 shd.state_leaves(cfg, shape.global_batch, shape.seq_len)}
        assert named.pop("pos") == ()
        assert named == {k: tuple(v) for k, v in leaves.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_match_reference(arch):
    ref = ref_specs.abstract_params(ref_get_config(arch))
    got = specs.abstract_params(get_config(arch))
    leaves = {n: (path, shape) for n, path, shape, _ in
              shd.param_leaves(get_config(arch))}
    assert set(got) == set(leaves)
    for name, t in got.items():
        path, stacked = leaves[name]
        node = ref
        for p in path.split("/"):
            node = node[int(p)] if isinstance(node, list) else node[p]
        assert tuple(node.shape) == stacked, name
        want = node.shape[1:] if len(stacked) > t.dim() else node.shape
        assert t.device.type == "meta" and _same(t, node, want), name
    opt = specs.abstract_opt_state(get_config(arch),
                                   AdamWConfig(compression="int8"))
    assert set(opt.mu) == set(opt.error) == set(got)


def test_model_flops_match_reference():
    for arch in list_archs():
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        for shape in shapes_for(ref_cfg):
            assert roofline.model_flops_for(cfg, shape) \
                == ref_roofline.model_flops_for(ref_cfg, shape), \
                (arch, shape.name)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_loop_counts_every_iteration():
    a, ws = _meta(128, 128), _meta(10, 128, 128)

    def unrolled(a, ws):
        for i in range(10):
            a = a @ ws[i]
        return a

    one = count_ops(lambda a, w: a @ w, a, ws[0])
    ten = count_ops(unrolled, a, ws)
    assert one.flops == 2 * 128 ** 3
    assert ten.flops == 10 * one.flops
    assert ten.bytes == 10 * one.bytes


def test_batched_matmul_counts_2bmnk():
    B, Mm, N, K = 3, 5, 7, 11
    c = count_ops(torch.matmul, _meta(B, Mm, K), _meta(B, K, N))
    assert c.flops == 2 * B * Mm * N * K
    # the operands once and the result once; the views move nothing
    assert c.bytes == 4 * (B * Mm * K + B * K * N + B * Mm * N)


def test_pointwise_transcendental_and_view_rules():
    x = _meta(4, 6)
    c = count_ops(lambda x: torch.exp(x * 2.0 + 1.0), x)
    assert c.flops == 2 * 24 and c.transcendentals == 24
    v = count_ops(lambda x: x.view(6, 4).t().unsqueeze(0), x)
    assert v.bytes == 0 and v.flops == 0


def test_reduced_dense_forward_matmul_flops():
    cfg = dataclasses.replace(reduced(get_config("olmo-1b")), remat="none")
    att = cfg.attention
    B, S = 2, 48
    d, H, Hkv, hd, ff = (cfg.d_model, att.n_heads, att.n_kv_heads,
                         att.head_dim, cfg.d_ff)
    T = B * S
    per_layer = (2 * T * d * H * hd            # q
                 + 2 * 2 * T * d * Hkv * hd    # k, v
                 + 2 * 2 * B * H * S * S * hd  # q·kᵀ and p·v, one chunk pair
                 + 2 * T * H * hd * d          # out
                 + 3 * 2 * T * d * ff)         # swiglu: gate, up, down
    model = specs.abstract_model(cfg)
    batch = {"tokens": _meta(B, S, dtype=torch.int32)}
    with torch.no_grad():
        c = count_ops(M.forward, model, batch)
    assert sum(c.by_op.values()) == cfg.num_layers * per_layer
    assert c.flops > sum(c.by_op.values())      # the pointwise work
    assert c.transcendentals > 0


FAMILIES = ["olmo-1b", "deepseek-v2-236b", "xlstm-125m", "jamba-v0.1-52b",
            "seamless-m4t-medium", "qwen2-vl-72b"]
CELLS = [ShapeConfig("train_s", 32, 4, "train"),
         ShapeConfig("prefill_s", 32, 4, "prefill"),
         ShapeConfig("decode_s", 32, 4, "decode")]


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_cell_on_reduced_configs(arch):
    cfg = reduced(get_config(arch))
    mesh = {"data": 2, "model": 2}
    cache = {}
    for shape in CELLS:
        row = dryrun.lower_cell(arch, shape, mesh=mesh, cfg=cfg,
                                cache=cache)
        assert row["status"] == "ok" and row["mesh"] == "2x2"
        assert row["chips"] == 4 and row["groups"] == 2
        for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                  "state_gib", "counted_flops_total", "useful_ratio",
                  "flops_per_chip", "bytes_per_chip"):
            assert math.isfinite(row[k]) and row[k] > 0, (shape.name, k)
        assert row["bottleneck"] in ("compute", "memory", "collective")
        assert row["t_compute_s"] == pytest.approx(
            row["flops_per_chip"] / roofline.PEAK_FLOPS)
        # a chip does at least its even share, at most the whole step
        assert row["counted_flops_total"] / 4 <= row["flops_per_chip"] \
            <= row["counted_flops_total"]
        assert sum(row["collectives"].values()) > 0
        one = dryrun.lower_cell(arch, shape, mesh={"data": 1, "model": 1},
                                cfg=cfg, cache=cache)
        assert one["t_collective_s"] == 0
        assert not any(one["collectives"].values())
        assert one["flops_per_chip"] == pytest.approx(
            one["counted_flops_total"], rel=1e-12)
        assert one["bytes_per_chip"] == pytest.approx(
            one["counted_bytes_total"], rel=1e-12)
    assert len(cache) == len(CELLS) + (cfg.moe is not None) * len(CELLS)


def test_check_spec_refuses_incoherent_plans():
    mesh = {"data": 4, "model": 2}
    dryrun.check_spec("ok", (8, 6), ("data", "model"), mesh)
    for spec, why in [(("data", None, None), "longer"),
                      (("pod", None), "not in the mesh"),
                      ((None, "data"), "does not divide"),
                      ((("data", "model"), "model"), "twice")]:
        with pytest.raises(ValueError, match=why):
            dryrun.check_spec("leaf", (8, 6), spec, mesh)


ROWS = [
    dict(arch="olmo-1b", shape="train_4k", mesh="16x16", status="ok",
         t_compute_s=0.0457, t_memory_s=0.2816, t_collective_s=0.5012,
         bottleneck="collective", useful_ratio=0.639,
         roofline_fraction=0.104, state_gib=0.069),
    dict(arch="olmo-1b", shape="decode_32k", mesh="2x16x16", status="ok",
         t_compute_s=3.37e-06, t_memory_s=1.2, t_collective_s=7.1e-4,
         bottleneck="memory", useful_ratio=0.353, roofline_fraction=1.2e-4,
         state_gib=32.01),
    dict(arch="arctic-480b", shape="prefill_32k", mesh="16x16",
         status="FAIL: ValueError: boom"),
]


@pytest.mark.parametrize("mesh_filter", [None, "16x16", "2x16x16"])
def test_render_equals_reference(mesh_filter):
    ref_rows = [{("peak_mem_gib" if k == "state_gib" else k): v
                 for k, v in r.items()} for r in ROWS]
    assert report.render(ROWS, mesh_filter) \
        == ref_report.render(ref_rows, mesh_filter)
    for x in (None, 2.5, 0.0123, 4.5e-5):
        assert report.fmt_s(x) == ref_report.fmt_s(x)


def test_render_by_arch_one_line_an_arch():
    rows = ROWS + [dict(ROWS[0], mesh="2x16x16", t_compute_s=0.0228,
                        state_gib=0.05)]
    text = report.render_by_arch(rows).splitlines()
    assert len(text) == 2 + 2           # header, rule, two archs
    assert text[0] == ("| arch | 16x16 train_4k | 16x16 decode_32k | "
                       "16x16 prefill_32k | 2x16x16 train_4k | "
                       "2x16x16 decode_32k | 2x16x16 prefill_32k |")
    assert text[2] == ("| olmo-1b | 45.7ms / 281.6ms / 501.2ms, 0.1GiB "
                       "|  |  | 22.8ms / 281.6ms / 501.2ms, 0.1GiB | "
                       "3us / 1.20s / 710us, 32.0GiB |  |")
    assert text[3] == ("| arctic-480b |  |  | FAIL: ValueError: boom |  "
                       "|  |  |")
