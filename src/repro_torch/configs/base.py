"""Config system of the port: the JAX package's ``configs/base.py``
(architecture configs, input shapes, the arch registry, ``BladeConfig``),
copied as data so that the port imports nothing of it.

Each architecture keeps a module ``repro_torch/configs/<id>.py`` with its
published ``CONFIG`` and its CPU-test ``SMOKE``; a module may add
``ONE_H100``, a cut of ``CONFIG`` that fits one 80 GB H100
(:func:`get_one_h100_arch`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0           # shared (always-on) experts
    d_ff: int = 0               # per-expert hidden dim
    every: int = 1              # MoE MLP on layers where (layer % every == every-1)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""
    kv_lora: int = 512
    q_lora: int = 0             # 0 => full-rank q projection
    rope_dim: int = 64          # decoupled rope key dim (shared across heads)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0            # 0 => ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    # which blocks in a period are sLSTM (others mLSTM); xLSTM[7:1] style
    slstm_every: int = 4        # layer % every == every-1 -> sLSTM
    proj_factor: float = 2.0    # up-projection factor inside mLSTM block
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    mlp: str = "swiglu"         # swiglu | squared_relu | gelu | geglu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    causal: bool = True         # False => encoder (bidirectional)
    # sliding-window attention (0 = full). Enables long_500k for dense archs.
    sliding_window: int = 0
    # hybrid layout: period pattern of block kinds, tiled over n_layers.
    # kinds: "attn" | "ssm" | "mlstm" | "slstm". None => all "attn".
    block_pattern: Optional[Tuple[str, ...]] = None
    n_dense_prefix: int = 0     # first layers use dense MLP even if MoE
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # vlm / audio frontends are stubs: inputs arrive as embeddings.
    vlm_prefix_len: int = 0     # number of image-patch embedding positions
    audio_frontend: bool = False
    source: str = ""            # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            return self.block_pattern
        return ("attn",)

    @property
    def has_decode(self) -> bool:
        return self.causal

    @property
    def subquadratic(self) -> bool:
        """True when long-context decode is affordable (no full-attn O(S) cache
        scan per step, or sliding window bounds it)."""
        kinds = set(self.pattern)
        if kinds <= {"ssm", "mlstm", "slstm"}:
            return True
        return self.sliding_window > 0 or "ssm" in kinds or "mlstm" in kinds

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb + d  # final norm
        for kind in self.layer_kinds():
            total += 2 * d  # per-block norms
            if kind == "attn":
                if self.mla is not None:
                    m = self.mla
                    q_in = m.q_lora or d
                    total += (d * m.q_lora if m.q_lora else 0)
                    total += q_in * self.n_heads * (hd + m.rope_dim)
                    total += d * (m.kv_lora + m.rope_dim)
                    total += m.kv_lora * self.n_heads * 2 * hd
                    total += self.n_heads * hd * d
                else:
                    total += d * self.n_heads * hd
                    total += 2 * d * self.n_kv_heads * hd
                    total += self.n_heads * hd * d
            elif kind == "ssm":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                dt_rank = s.dt_rank or -(-d // 16)
                total += d * 2 * d_in              # in_proj (x, z)
                total += d_in * s.d_conv           # depthwise conv
                total += d_in * (dt_rank + 2 * s.d_state)
                total += dt_rank * d_in + d_in     # dt proj + bias
                total += d_in * s.d_state + d_in   # A_log, D
                total += d_in * d                  # out_proj
            elif kind in ("mlstm", "slstm"):
                x = self.xlstm or XLSTMConfig()
                d_in = int(x.proj_factor * d)
                total += d * 2 * d_in              # up proj (x, z)
                total += 3 * d_in * d_in // max(self.n_heads, 1) * self.n_heads  # qkv-ish
                total += 3 * d_in                  # gates
                total += d_in * d                  # down proj
        # MLP params per layer (dense vs MoE), done in a second pass for clarity
        for i in range(self.n_layers):
            use_moe = (
                self.moe is not None
                and i >= self.n_dense_prefix
                and i % self.moe.every == self.moe.every - 1
            )
            gated = self.mlp in ("swiglu", "geglu")
            mult = 3 if gated else 2
            if use_moe:
                m = self.moe
                total += m.n_experts * mult * d * m.d_ff
                total += m.n_shared * mult * d * m.d_ff
                total += d * m.n_experts  # router
            elif self.d_ff > 0:
                total += mult * d * self.d_ff
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top_k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        gated = self.mlp in ("swiglu", "geglu")
        mult = 3 if gated else 2
        total = self.param_count()
        n_moe_layers = sum(
            1
            for i in range(self.n_layers)
            if i >= self.n_dense_prefix and i % m.every == m.every - 1
        )
        inactive = (m.n_experts - m.top_k) * mult * d * m.d_ff * n_moe_layers
        return int(total - inactive)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

SMOKE_SHAPES = {
    "smoke_train": ShapeConfig("smoke_train", 64, 4, "train"),
    "smoke_prefill": ShapeConfig("smoke_prefill", 64, 2, "prefill"),
    "smoke_decode": ShapeConfig("smoke_decode", 64, 2, "decode"),
}


# ---------------------------------------------------------------------------
# BLADE-FL experiment config (paper substrate)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BladeConfig:
    """Paper §7 experimental knobs (time normalized by alpha as in the paper)."""
    n_clients: int = 20
    n_lazy: int = 0
    sigma2: float = 0.0          # lazy artificial-noise variance
    t_sum: float = 100.0         # total computing time budget
    alpha: float = 1.0           # training time per local iteration
    beta: float = 10.0           # mining time per block
    eta: float = 0.01            # learning rate
    K: int = 5                   # integrated rounds
    samples_per_client: int = 512
    dirichlet_alpha: float = 0.5 # non-IID-ness
    dp_sigma: float = 0.0        # DP Gaussian mechanism on broadcast models
    seed: int = 0

    @property
    def tau(self) -> int:
        from repro_torch.core.allocation import tau_from_budget
        return tau_from_budget(self.t_sum, self.K, self.alpha, self.beta)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_ARCH_IDS = (
    "xlstm-125m",
    "qwen3-32b",
    "nemotron-4-15b",
    "jamba-1.5-large-398b",
    "paligemma-3b",
    "hubert-xlarge",
    "phi4-mini-3.8b",
    "kimi-k2-1t-a32b",
    "minicpm-2b",
    "deepseek-v2-236b",
)


def arch_ids() -> Sequence[str]:
    return _ARCH_IDS


def _arch_module(arch_id: str):
    import importlib

    mod_name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_arch(arch_id: str) -> ModelConfig:
    return _arch_module(arch_id).CONFIG


def get_smoke_arch(arch_id: str) -> ModelConfig:
    return _arch_module(arch_id).SMOKE


def get_one_h100_arch(arch_id: str) -> ModelConfig:
    """The module's ``ONE_H100`` config (published widths cut to fit one
    80 GB H100). Raises ValueError for an architecture without one."""
    mod = _arch_module(arch_id)
    if not hasattr(mod, "ONE_H100"):
        raise ValueError(f"{arch_id} has no one-H100 configuration; "
                         "pass --size smoke")
    return mod.ONE_H100


def get_shape(name: str) -> ShapeConfig:
    if name in INPUT_SHAPES:
        return INPUT_SHAPES[name]
    return SMOKE_SHAPES[name]
