"""The decoder-only transformer family (``models/transformer.py`` of the
port; the reference's :mod:`fl_bench.reference.transformer`): RMSNorm,
causal grouped-query attention with rotary embeddings, a SwiGLU MLP, a
tied head, one block repeated ``n_layers`` times."""
from typing import Mapping

from fl_bench.counts import causal_pairs
from fl_bench.reference import transformer as reference

# reference leaf -> the port's flattened leaf (``repro_torch.tree.flatten``)
PORT_LEAVES = {
    "embed": "embed",
    "final_norm": "final_norm/scale",
    "attn_norm": "period/j0/norm1/scale",
    "wq": "period/j0/mixer/w_q",
    "wk": "period/j0/mixer/w_k",
    "wv": "period/j0/mixer/w_v",
    "wo": "period/j0/mixer/w_o",
    "mlp_norm": "period/j0/norm2/scale",
    "w_gate": "period/j0/mlp/w_gate",
    "w_up": "period/j0/mlp/w_in",
    "w_down": "period/j0/mlp/w_out",
}
# configuration keys the port's config must hold as the file states them
WIDTH_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "mlp", "rope_theta", "norm_eps",
              "tie_embeddings")
FORWARD_KERNELS = ("flash_attention",)
BACKWARD_KERNELS = ("flash_attention_bwd",)


def port_mismatch(cfg, widths: Mapping) -> dict:
    """{key: (the port's, the file's)} for each width that differs."""
    wrong = {k: (getattr(cfg, k), widths[k]) for k in WIDTH_KEYS
             if getattr(cfg, k) != widths[k]}
    if cfg.resolved_head_dim != widths["head_dim"]:
        wrong["resolved_head_dim"] = (cfg.resolved_head_dim,
                                      widths["head_dim"])
    return wrong


def attention_layers(widths: Mapping) -> int:
    return widths["n_layers"]


def matmul_weights(widths: Mapping) -> int:
    """Weights that enter a matrix product once a token: every layer's
    projections and MLP, and the tied head once (the embedding's lookup
    does none)."""
    d, hd, L = widths["d_model"], widths["head_dim"], widths["n_layers"]
    h, hkv, ff = widths["n_heads"], widths["n_kv_heads"], widths["d_ff"]
    per_layer = d * h * hd + 2 * d * hkv * hd + h * hd * d + 3 * d * ff
    return L * per_layer + widths["vocab"] * d


def forward_flops(widths: Mapping, sequences: int, seq: int) -> float:
    """One forward pass over ``sequences`` x ``seq`` tokens: 2 flops a
    matmul weight a token, and 4 D a kept pair a head a layer (QK^T and
    PV)."""
    attn = 4 * widths["head_dim"] * widths["n_heads"] * causal_pairs(seq)
    return (2.0 * matmul_weights(widths) * sequences * seq
            + float(widths["n_layers"]) * sequences * attn)


def init_leaf(name: str, leaf) -> None:
    """In place, on N(0, 1) draws: the norm scales ones, the embedding
    scaled by 0.02, each matrix by fan_in**-0.5."""
    if name.endswith("norm"):
        leaf.fill_(1.0)
    else:
        leaf.mul_(0.02 if name == "embed" else leaf.shape[-2] ** -0.5)
