"""Model configuration covering all 10 assigned architecture families."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    # >1: grouped 2D dispatch — tokens are ranked/scattered within
    # dispatch_groups groups (set = data-axis size) so the [G, E, C, D]
    # buffer shards (data, model) and the global-scatter all-reduce
    # pathology disappears (§Perf bonus iteration)
    dispatch_groups: int = 1


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The audio conv frontend is
    a STUB per the assignment: input_specs() feeds precomputed frame
    embeddings of shape [B, n_frames, d_model]."""
    n_layers: int
    n_frames: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 => d_model // n_heads
    # Per-layer block pattern, cycled over n_layers. Kinds:
    #   'attn'  full self-attention      'local' sliding-window attention
    #   'rglru' RG-LRU recurrent block   'ssm'   mamba1 block
    #   'xattn' self-attn + cross-attn (VLM/enc-dec decoder layers)
    block_pattern: tuple = ("attn",)
    local_window: int = 4096
    qkv_bias: bool = False
    attn_softcap: float | None = None
    logit_softcap: float | None = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "swiglu"                  # 'swiglu' | 'gelu'
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encoder: EncoderConfig | None = None
    n_patch_tokens: int = 0              # VLM stub frontend token count
    tie_embeddings: bool = False
    # families: 'dense' | 'moe' | 'ssm' | 'hybrid' | 'vlm' | 'audio'
    family: str = "dense"
    # shapes eligible for long_500k (sub-quadratic archs only)
    supports_long_context: bool = False
    # perf knobs (hillclimb; see EXPERIMENTS.md §Perf):
    #   attn_q_chunk: query-chunked attention — causal chunks slice K/V to
    #   [0, chunk_end) and local chunks to the window band, i.e. the APRIL
    #   A-interval restriction of the mask expressed in XLA. Cuts the S x S
    #   score buffer to chunk x band and drops masked-out FLOPs.
    attn_q_chunk: int | None = None

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_cycles(self) -> int:
        """Scanned cycles; remainder layers become the unscanned tail."""
        return self.n_layers // self.pattern_period

    @property
    def tail_kinds(self) -> tuple:
        """Layers beyond the last full cycle (e.g. Griffin's trailing R, R
        after eight (R, R, A) triples), applied after the scan."""
        return tuple(self.block_pattern[: self.n_layers % self.pattern_period])

    def layer_kinds(self) -> list[str]:
        return [self.block_pattern[i % self.pattern_period]
                for i in range(self.n_layers)]

    def param_count(self) -> int:
        """Approximate parameter count (embeddings included)."""
        d, dh = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind in ("attn", "local", "xattn"):
                attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * dh * d
                if kind == "xattn":
                    attn *= 2
                total += attn
            elif kind == "rglru":
                total += 2 * d * d + 2 * d
            elif kind == "ssm":
                di = self.ssm.expand * d
                total += d * di * 2 + di * (self.ssm.d_state * 2 + 1) + di * d
            if self.moe is not None:
                total += self.moe.num_experts * 3 * d * self.moe.d_ff_expert \
                    + d * self.moe.num_experts
            elif kind != "ssm":
                mults = 3 if self.act == "swiglu" else 2
                total += mults * d * self.d_ff
        if self.encoder is not None:
            enc_layer = 4 * d * dh * self.n_heads + 2 * 2 * d * self.d_ff
            total += self.encoder.n_layers * enc_layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            self.moe.num_experts * 3 * d * self.moe.d_ff_expert)
        return int(dense + self.n_layers * self.moe.top_k * 3 * d
                   * self.moe.d_ff_expert)
