"""Model configuration for every assigned architecture family (the port's
copy of the reference's ``models/config.py``; ``dtype`` stays a string,
:func:`repro_torch.models.lm.torch_dtype` maps it to a ``torch.dtype``).

One `ModelConfig` dataclass covers dense / MoE / SSM / hybrid / enc-dec /
VLM-backbone families; family-specific sub-configs are optional fields.
The exact published dimensions live in ``repro_torch.configs.<arch_id>``.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int          # per-expert hidden width
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (state-space duality, arXiv:2405.21060)."""
    d_state: int
    head_dim: int = 64
    expand: int = 2            # d_inner = expand * d_model
    chunk: int = 256           # SSD chunk length
    conv_width: int = 4
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + a single *shared* attention block
    instantiated every ``attn_period`` layers (arXiv:2411.15242).  The
    shared block is the paper's one-definition/many-instances pattern
    realized with literally shared weights."""
    attn_period: int = 6


@dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder; conv frontend is a stub that takes
    precomputed frame embeddings per the assignment."""
    n_encoder_layers: int = 12
    n_audio_ctx: int = 1500     # frames after conv stride (whisper: 30s)


@dataclass(frozen=True)
class VLMConfig:
    """Phi-3-vision-style: the transformer backbone consumes precomputed
    CLIP patch embeddings (frontend stubbed per the assignment)."""
    n_patches: int = 576
    d_patch: int = 1024         # projected to d_model by a learned matrix


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int               # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_seq_len: int = 131_072
    dtype: str = "bfloat16"
    # family extensions
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # attention behaviour
    causal: bool = True
    sliding_window: Optional[int] = None   # starcoder2 uses 4096 in HF cfg
    # implementation selectors (S:Perf levers; defaults = paper-faithful
    # baseline)
    attn_impl: str = "naive"               # naive | chunked | kernel
    moe_impl: str = "scatter"              # scatter | dense (GShard einsum)
    kv_quant: bool = False                 # int8 KV cache (serving)

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (sub-quadratic sequence cost)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encdec is not None

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        n = V * d                      # token embedding
        if not self.tie_embeddings:
            n += V * d                 # lm head
        n += d                         # final norm
        per_layer = 0
        if self.family in ("dense", "moe", "vlm"):
            hd = self.hd
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            # qk-norm: one [hd] scale for q and one for k, shared by
            # every head (the reference counts 2 * n_heads * hd here, more
            # than its init_params creates)
            attn = q + kv + o + (2 * hd if self.qk_norm else 0)
            if self.moe is not None:
                ff = self.moe.n_experts * 3 * d * self.moe.d_ff_expert
                ff += d * self.moe.n_experts      # router
            else:
                ff = 3 * d * self.d_ff            # gate/up/down
            per_layer = attn + ff + 2 * d         # two norms
        elif self.family in ("ssm", "hybrid"):
            per_layer = self._ssm_layer_params()
        n += L * per_layer
        if self.family == "hybrid":
            # one shared attention+MLP block
            hd = self.hd
            shared = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd +
                      self.n_heads * hd * d + 3 * d * self.d_ff + 2 * d)
            n += shared
        if self.encdec is not None:
            # MHA self- and cross-attention, the two-matrix GELU MLP with
            # its biases, LayerNorms of scale and bias (the reference
            # counts the MLP as SwiGLU and each norm as one vector)
            attn = 4 * d * self.n_heads * self.hd
            mlp2 = 2 * d * self.d_ff + self.d_ff + d
            ln = 2 * d
            n += L * (2 * attn + mlp2 + 3 * ln)        # decoder layers
            n += self.encdec.n_encoder_layers * (attn + mlp2 + 2 * ln)
            n += self.encdec.n_audio_ctx * d + ln      # positions, norm
        if self.vlm is not None:
            n += self.vlm.d_patch * d             # patch projection
        return n

    def _ssm_layer_params(self) -> int:
        d = self.d_model
        s = self.ssm
        di = s.d_inner(d)
        nh = s.n_heads(d)
        conv_ch = di + 2 * s.n_groups * s.d_state
        n = d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj (zxbcdt)
        # conv1d weight and bias (the reference counts no conv_b, and
        # counts dt_bias and the gate norm as di together: it is nh + di)
        n += (s.conv_width + 1) * conv_ch
        n += nh * 3                                # A_log, D, dt_bias
        n += di                                    # gate norm
        n += di * d                                # out_proj
        n += d                                     # pre-norm
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        inactive = self.n_layers * (self.moe.n_experts - self.moe.top_k) \
            * 3 * d * self.moe.d_ff_expert
        return full - inactive

    def with_reduced(self, **kw) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        nh = 4 if self.n_heads else 0
        # preserve the attention class: MHA stays MHA, GQA stays grouped
        nkv = nh if self.n_kv_heads == self.n_heads else \
            (min(self.n_kv_heads, 2) if self.n_heads else 0)
        base = dict(
            n_layers=2, d_model=64,
            n_heads=nh, n_kv_heads=nkv,
            d_ff=128, vocab=256, head_dim=16,
            max_seq_len=512,
        )
        if self.moe is not None:
            base["moe"] = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32)
        if self.ssm is not None:
            base["ssm"] = SSMConfig(d_state=16, head_dim=16, chunk=16)
        if self.hybrid is not None:
            base["hybrid"] = HybridConfig(attn_period=2)
        if self.encdec is not None:
            base["encdec"] = EncDecConfig(n_encoder_layers=2, n_audio_ctx=32)
        if self.vlm is not None:
            base["vlm"] = VLMConfig(n_patches=8, d_patch=32)
        base.update(kw)
        return replace(self, **base)


# ---------------------------------------------------------------------------
# input shapes assigned to the LM family (seq_len x global_batch)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> tuple[bool, str]:
    """Cell-applicability rules from the assignment.

    * ``long_500k`` needs sub-quadratic attention — only SSM/hybrid run it.
    * encoder-only archs would skip decode shapes (none assigned are).
    """
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch; 512k-token decode "
                       "requires sub-quadratic sequence mixing")
    return True, ""
