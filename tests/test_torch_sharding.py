"""The port's sharding plans (repro_torch/distributed/sharding.py) against
the JAX reference's specs, entry for entry.

* ``tree_pspecs`` equals the reference's ``tree_pspecs`` leaf for leaf,
  for all ten configs at full size, on meshes 16×16, 2×16×16, 8×1, 1×8
  and 2×4, in both sharding modes; the optimizer-state prefixes too.
* ``batch_pspecs`` equals ``batch_shardings`` for every config × its
  shapes; ``state_pspecs`` equals ``state_shardings`` for every config ×
  its decode shapes; ``hint_pspec`` equals the spec ``hint`` constrains
  to, on a grid of shapes and logical names.
* The reference's quirks (ROADMAP queue 3 item 12) are pinned.
* ``shard_bytes`` on hand-worked cases.

The reference functions read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a namespace stands in for a jax ``Mesh``;
where they build a ``NamedSharding`` it is patched to return the spec.
"""
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs, shapes_for
from repro.distributed import sharding as rs
from repro.launch import specs as ref_specs
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as ts
from repro_torch.launch import specs as port_specs
from repro_torch.models.transformer import build_segments

MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "8x1": {"data": 8, "model": 1},
    "1x8": {"data": 1, "model": 8},
    "2x4": {"data": 2, "model": 4},
}
MODES = ("hybrid", "fsdp")


def _ref_mesh(mesh: dict):
    return types.SimpleNamespace(axis_names=tuple(mesh),
                                 devices=np.empty(tuple(mesh.values())))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    return ref_specs.abstract_params(ref_get_config(arch))


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _ref_spec_tree(tree) -> dict:
    """Reference path → spec tuple, for a tree of PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {_path(k): tuple(v) for k, v in flat}


@pytest.fixture
def no_named_sharding(monkeypatch):
    monkeypatch.setattr(rs, "NamedSharding", lambda m, s: s)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tree_pspecs_match_reference(mesh_name, mode, monkeypatch):
    mesh = MESHES[mesh_name]
    monkeypatch.setenv("REPRO_SHARDING_MODE", mode)
    for arch in list_archs():
        ref = _ref_spec_tree(rs.tree_pspecs(_ref_params(arch),
                                            _ref_mesh(mesh)))
        leaves = list(ts.param_leaves(get_config(arch)))
        assert {p for _, p, _, _ in leaves} == set(ref), arch
        port = ts.tree_pspecs(get_config(arch), mesh, mode)
        for name, path, _, _ in leaves:
            assert port[name] == ref[path], (arch, name, port[name],
                                             ref[path])


def test_mode_none_reads_the_environment(monkeypatch):
    cfg = get_config("olmo-1b")
    mesh = MESHES["2x4"]
    monkeypatch.setenv("REPRO_SHARDING_MODE", "fsdp")
    assert ts.batch_pspec(mesh, 8) == (("data", "model"), None)
    assert ts.tree_pspecs(cfg, mesh) == ts.tree_pspecs(cfg, mesh, "fsdp")
    monkeypatch.delenv("REPRO_SHARDING_MODE")
    assert ts.batch_pspec(mesh, 8) == ("data", None)


def test_opt_state_prefixes_match_reference():
    """An ``OptState`` with int8 error feedback: every moment shards like
    its parameter, the step replicated."""
    arch = "deepseek-v2-236b"
    mesh = MESHES["16x16"]
    opt = ref_specs.abstract_opt_state(ref_get_config(arch),
                                       RefAdamWConfig(compression="int8"))
    ref = rs.tree_pspecs(opt, _ref_mesh(mesh))
    assert tuple(ref.step) == ()
    leaves = list(ts.param_leaves(get_config(arch)))
    for field in ("mu", "nu", "error"):
        want = _ref_spec_tree(getattr(ref, field))
        port = ts.tree_pspecs(get_config(arch), mesh, prefix=field + "/")
        assert len(want) == len({p for _, p, _, _ in leaves})
        for name, path, _, _ in leaves:
            assert port[name] == want[path], (field, name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspecs_match_reference(mesh_name, mode, monkeypatch,
                                      no_named_sharding):
    mesh = MESHES[mesh_name]
    monkeypatch.setenv("REPRO_SHARDING_MODE", mode)
    for arch in list_archs():
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        for shape in shapes_for(ref_cfg):
            batch = ref_specs.input_specs(ref_cfg, shape)
            want = rs.batch_shardings(ref_cfg, _ref_mesh(mesh), batch)
            got = ts.batch_pspecs(cfg, mesh,
                                  port_specs.input_specs(cfg, shape), mode)
            assert set(got) == set(want), (arch, shape.name)
            for k in want:
                assert got[k] == tuple(want[k]), (arch, shape.name, k)
            # the shapes alone give the same
            assert ts.batch_pspecs(cfg, mesh, {k: v.shape for k, v in
                                               batch.items()}, mode) == got


def _ref_state_specs(ref_state, cfg) -> dict:
    """Port leaf name → the reference's spec of the leaf it comes from:
    ``caches[si]["pos{j}"].field`` row ``period`` is the port's layer
    cache, layers in (segment, period, position) order."""
    out, layer = {}, 0
    for si, seg in enumerate(build_segments(cfg)):
        for _ in range(seg.n_periods):
            for j in range(len(seg.period)):
                cache = ref_state["caches"][si][f"pos{j}"]
                for f in cache._fields:
                    if f == "pos":
                        assert tuple(getattr(cache, f)) == ()
                        out["pos"] = ()
                    else:
                        out[f"caches.{layer}.{f}"] = tuple(getattr(cache, f))
                layer += 1
    out.setdefault("pos", ())     # no attention cache: the port's position
    for f in ("enc_out", "enc_pos"):
        if f in ref_state:
            out[f] = tuple(ref_state[f])
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_state_pspecs_match_reference(mesh_name, mode, monkeypatch,
                                      no_named_sharding):
    mesh = MESHES[mesh_name]
    monkeypatch.setenv("REPRO_SHARDING_MODE", mode)
    for arch in list_archs():
        ref_cfg, cfg = ref_get_config(arch), get_config(arch)
        for shape in shapes_for(ref_cfg):
            if shape.kind != "decode":
                continue
            B = shape.global_batch
            _, state = ref_specs.decode_specs(ref_cfg, shape)
            want = _ref_state_specs(
                rs.state_shardings(_ref_mesh(mesh), state, B), cfg)
            got = ts.state_pspecs(cfg, mesh, B, shape.seq_len, mode)
            assert got == want, (arch, shape.name)


LOGICAL = [("batch", None, "model"), ("batch", "model"), ("model", "batch"),
           (None, "model", "model"), ("batch", "batch", None),
           ("model", None, "batch", "model"), (None,), ("batch",)]
SHAPES = [(256, 4096, 16), (8, 10, 32), (1, 7, 3), (128, 50304),
          (2, 16, 16, 3), (6, 24, 40, 8), (512,)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_hint_pspec_matches_reference(mesh_name, mode, monkeypatch,
                                      no_named_sharding):
    mesh = MESHES[mesh_name]
    monkeypatch.setenv("REPRO_SHARDING_MODE", mode)
    monkeypatch.setattr(rs, "current_mesh", lambda: _ref_mesh(mesh))
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    for shape in SHAPES:
        for logical in LOGICAL:
            want = rs.hint(types.SimpleNamespace(shape=shape), *logical)
            got = ts.hint_pspec(shape, logical, mesh, mode)
            assert got == tuple(want), (shape, logical, got, want)


def test_quirk_stacked_leaf_rule_lands_on_the_period_axis():
    """Queue 3 item 12: the per-period rule on a stacked leaf."""
    port = ts.tree_pspecs(get_config("olmo-1b"), MESHES["16x16"], "hybrid")
    assert port["layers.0.3.pos0.attn.wq"] == ("data", "model", None, None)
    ref = _ref_spec_tree(rs.tree_pspecs(_ref_params("olmo-1b"),
                                        _ref_mesh(MESHES["16x16"])))
    assert ref["layers/0/pos0/attn/wq"] == ("data", "model", None, None)


def test_quirk_cache_pspec_assumes_a_stack_axis_on_the_memory(
        monkeypatch):
    """Queue 3 item 12: ``enc_out [B, S_enc, d]`` at decode_32k."""
    monkeypatch.delenv("REPRO_SHARDING_MODE", raising=False)
    got = ts.state_pspecs(get_config("seamless-m4t-medium"),
                          MESHES["16x16"], 128, 32768)
    assert got["enc_out"] == (None, "data", "model")
    assert got["enc_pos"] == (None, "data")


def test_shard_bytes_hand_worked():
    mesh = {"pod": 2, "data": 16, "model": 16}
    f32, bf16 = torch.float32, torch.bfloat16
    assert ts.shard_bytes((4096, 1024), f32, (), mesh) == 4096 * 1024 * 4
    # 1024 rows over model, 2048 columns over pod × data
    assert ts.shard_bytes((1024, 2048), bf16, ("model", ("pod", "data")),
                          mesh) == (1024 // 16) * (2048 // 32) * 2
    # a shorter spec leaves the trailing dimensions whole
    assert ts.shard_bytes((16, 2048, 16, 128), f32, ("data", "model"),
                          mesh) == 1 * 128 * 16 * 128 * 4
    # a dimension the axes do not divide: the largest block a chip holds
    assert ts.shard_bytes((10, 3), torch.int32, ("model", None), mesh) \
        == 1 * 3 * 4
    assert ts.shard_bytes((), torch.int32, (), mesh) == 4


def test_quirk_fsdp_cache_pspec_names_model_twice(monkeypatch):
    """Queue 3 item 12: under fsdp the batch takes ``('data', 'model')``
    and a later axis ``model`` again, which the dry-run refuses as a
    ``NamedSharding`` would."""
    from repro_torch.launch.dryrun import check_spec
    monkeypatch.setenv("REPRO_SHARDING_MODE", "fsdp")
    mesh, shape = MESHES["2x4"], (4, 128, 1024, 8, 64)
    got = ts.cache_pspec(mesh, shape, 128)
    assert got == (None, ("data", "model"), "model", None, None)
    assert got == tuple(rs.cache_pspec(_ref_mesh(mesh), shape, 128))
    with pytest.raises(ValueError, match="twice"):
        check_spec("caches/0/pos0/k", shape, got, mesh)
