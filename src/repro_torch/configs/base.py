"""Configuration dataclasses (PyTorch port): the walk engine's configs
and the model configs of the walk-native LM (``ModelConfig`` and its
attention, MoE and SSM parts, the input shapes, ``reduced``).

Field names and defaults are those of the JAX package's
``repro/configs/base.py``, copied so the port imports nothing of it.
Everything is a frozen dataclass, so configs hash.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple


@dataclass(frozen=True)
class WindowConfig:
    """Sliding-window semantics (paper §2.6)."""

    duration: float = 3600.0          # Δ, in timestamp units
    edge_capacity: int = 1 << 16      # static capacity of the edge store
    node_capacity: int = 1 << 12      # max node id + 1
    drop_late: bool = True            # drop edges older than t - Δ at merge


@dataclass(frozen=True)
class SamplerConfig:
    """Temporal bias sampling (paper §2.5).

    The port serves every bias of the reference, ``"table"`` and
    node2vec (p, q) included; ``core.walk_engine.check_capabilities``
    refuses what the reference refuses.
    """

    bias: str = "exponential"         # uniform | linear | exponential | table
    mode: str = "index"               # index (closed-form O(1)) | weight (exact, O(log n))
    start_bias: str = "uniform"       # bias over start edges (timestamp view)
    node2vec_p: float = 1.0
    node2vec_q: float = 1.0
    table_weight: Optional[Callable] = None
    table_radix: int = 4096
    table_degree_cap: int = 64


@dataclass(frozen=True)
class SchedulerConfig:
    """Per-hop dispatch (paper §2.4): every path and regroup of the
    reference."""

    path: str = "grouped"             # fullwalk | grouped | tiled | fused
    regroup: str = "bucket"           # bucket | lexsort
    regroup_time: bool = True         # conditional time subsort inside buckets
    solo_threshold: int = 4
    tile_walks: int = 256             # walks per tile (one CTA on the card)
    tile_edges: int = 1024            # edges per staged block; the panel is 2 blocks
    max_task_walks: int = 8192
    compact_threshold: float = 0.5


@dataclass(frozen=True)
class WalkConfig:
    """A walk-generation request (paper defaults: L=80, 10 walks/node)."""

    num_walks: int = 1024
    max_length: int = 80
    start_mode: str = "nodes"         # nodes | edges | all_nodes
    direction: str = "forward"


@dataclass(frozen=True)
class ServeConfig:
    """Walk-query serving layer (repro_torch.serve, DESIGN.md §11).

    A coalesced batch always runs at a bucketed (lane count, length), never
    at the exact query shape; buckets are sorted ascending and the largest
    lane bucket is the lane budget of one batch. ``max_inflight`` bounds
    the ring of launched, unharvested batches (1 is the synchronous loop);
    ``linger_s`` keeps a partly filled batch open to late same-group
    queries until its head query has waited that long; ``admission`` is
    the head-of-line order, ``"fifo"`` or ``"edf"`` (earliest
    ``WalkQuery.deadline_s`` first). ``num_shards`` > 0 serves from a
    node-partitioned window of that many shards (DESIGN.md §13).
    """

    queue_capacity: int = 1024        # pending-query slots; beyond -> dropped
    lane_buckets: Tuple[int, ...] = (64, 256, 1024, 4096)
    length_buckets: Tuple[int, ...] = (4, 8, 16, 32, 80)
    drop_oversize: bool = True        # False: oversize submits raise (typed)
    num_shards: int = 0               # 0 = single window
    max_inflight: int = 4             # in-flight batch ring depth (>= 1)
    linger_s: float = 0.0             # continuous-batching seal deadline
    admission: str = "fifo"           # fifo | edf


@dataclass(frozen=True)
class ShardConfig:
    """Node-partitioned sliding window (repro_torch.distributed.
    streaming_shard, DESIGN.md §12).

    Capacities are per shard and static: overflow at any stage drops rows
    and counts them, never reshapes. ``exchange_capacity`` bounds how many
    batch edges one shard may send to one destination shard per ingest
    (provision for owner skew: a hub-owning shard can receive up to
    ``num_shards * exchange_capacity`` edges per batch);
    ``walk_bucket_capacity`` is the walk-migration analogue (also
    ``make_distributed_walker``'s bucket knob); ``walk_slots`` bounds the
    walks resident on one shard between hops.

    ``placement`` selects the node-ownership policy
    (repro_torch.distributed.placement, DESIGN.md §15): ``range`` is
    ``owner(v) = v // ceil(nc / D)``; ``hash`` decorrelates owners from
    id locality through a multiplicative hash and a ``hash_buckets``-entry
    routing table; ``skew`` starts as range and grows a measured
    top-``hot_k`` hub override table through
    ``DistributedStreamingEngine.rebalance``.
    """

    num_shards: int = 0                # 0 = one shard per device given
    edge_capacity_per_shard: int = 1 << 16
    exchange_capacity: int = 1 << 12   # batch edges per (sender, dest) pair
    walk_slots: int = 1 << 12          # resident walk rows per shard
    walk_bucket_capacity: int = 1 << 10  # migrating walks per (sender, dest)
    placement: str = "range"           # range | hash | skew (DESIGN.md §15)
    hash_buckets: int = 256            # routing-table entries (power of two)
    hot_k: int = 8                     # hub overrides built by rebalance()


@dataclass(frozen=True)
class EngineConfig:
    window: WindowConfig = field(default_factory=WindowConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    shard: ShardConfig = field(default_factory=ShardConfig)
    timestamp_dtype: str = "int32"
    seed: int = 0


# ---------------------------------------------------------------------------
# Model configs (assigned architectures)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    kind: str = "gqa"                 # gqa | mla
    n_heads: int = 16
    n_kv_heads: int = 16
    head_dim: int = 128
    qkv_bias: bool = False
    rope: str = "rope"                # rope | mrope | none | sinusoidal
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()   # M-RoPE (Qwen2-VL): (t, h, w) split of head_dim/2
    # MLA (DeepSeek-V2) parameters
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # sliding window for long-context decode on hybrid archs (0 = full)
    window: int = 0


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    num_shared_experts: int = 0
    shared_d_ff: int = 0
    dense_residual: bool = False      # Arctic: dense FFN in parallel with MoE
    dense_residual_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    every_k_layers: int = 1           # Jamba: MoE every 2nd layer
    first_dense_layers: int = 0       # DeepSeek-V2: layer 0 dense


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"               # mamba | mlstm | slstm
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk_size: int = 256             # chunked-scan block for training
    chunked: bool = True              # chunkwise-parallel mLSTM (§Perf)
    # xLSTM
    num_heads: int = 4
    proj_factor: float = 2.0


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"             # dense | moe | hybrid | ssm | enc_dec | vlm | audio
    num_layers: int = 12
    d_model: int = 768
    d_ff: int = 3072
    vocab_size: int = 50304
    attention: AttentionConfig = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # per-layer kind pattern, cycled over num_layers. Entries:
    #   "attn" (attention + FFN), "mamba" (mamba + FFN), "mlstm", "slstm"
    layer_pattern: Tuple[str, ...] = ("attn",)
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparametric_ln
    activation: str = "swiglu"        # swiglu | gelu | geglu
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    dtype: str = "bfloat16"
    # encoder for enc-dec (seamless): shares d_model/heads, own layer count
    encoder_layers: int = 0
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    frontend_dim: int = 0             # dim of precomputed frame/patch embeddings
    # long-context capability: archs with sub-quadratic paths run long_500k
    supports_long_context: bool = False
    # remat policy for train_step
    remat: str = "block"              # none | block | full

    @property
    def head_dim(self) -> int:
        return self.attention.head_dim

    def approx_params(self) -> int:
        """Crude parameter count (used by 6ND roofline term)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def approx_active_params(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


# ---------------------------------------------------------------------------
# Input shapes (assigned shape suite)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The shape cells an architecture actually runs.

    ``long_500k`` requires a sub-quadratic path (SSM / hybrid); pure
    full-attention archs skip it (recorded in DESIGN.md §5).
    """
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return tuple(out)


def reduced(cfg: ModelConfig, layers: int = 2, d_model: int = 64,
            vocab: int = 256, experts: int = 4) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving the family topology."""
    att = cfg.attention
    hd = 16
    n_heads = max(2, min(4, att.n_heads))
    n_kv = max(1, min(n_heads, att.n_kv_heads if att.n_kv_heads else n_heads))
    if n_heads % n_kv:
        n_kv = 1
    new_att = dataclasses.replace(
        att,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        q_lora_rank=min(att.q_lora_rank, 32) if att.q_lora_rank else 0,
        kv_lora_rank=min(att.kv_lora_rank, 16) if att.kv_lora_rank else 0,
        qk_nope_head_dim=hd if att.qk_nope_head_dim else 0,
        qk_rope_head_dim=8 if att.qk_rope_head_dim else 0,
        v_head_dim=hd if att.v_head_dim else 0,
        mrope_sections=(4, 2, 2) if att.mrope_sections else (),
    )
    new_moe = None
    if cfg.moe is not None:
        m = cfg.moe
        new_moe = dataclasses.replace(
            m,
            num_experts=min(m.num_experts, experts),
            top_k=min(m.top_k, 2),
            expert_d_ff=96 if m.expert_d_ff else 0,
            num_shared_experts=min(m.num_shared_experts, 1),
            shared_d_ff=96 if m.shared_d_ff else 0,
            dense_residual_d_ff=96 if m.dense_residual_d_ff else 0,
        )
    new_ssm = None
    if cfg.ssm is not None:
        new_ssm = dataclasses.replace(
            cfg.ssm, d_state=8, chunk_size=32,
            num_heads=2, expand=2,
        )
    n_layers = max(layers, len(cfg.layer_pattern))
    # keep a full pattern period so every block kind is exercised
    n_layers = min(n_layers, 2 * len(cfg.layer_pattern)) if len(cfg.layer_pattern) > 1 else layers
    return dataclasses.replace(
        cfg,
        num_layers=n_layers,
        d_model=d_model,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=vocab,
        attention=new_att,
        moe=new_moe,
        ssm=new_ssm,
        encoder_layers=min(cfg.encoder_layers, 2),
        frontend_dim=32 if cfg.frontend_dim else 0,
        max_seq_len=512,
        dtype="float32",
        remat="none",
    )
