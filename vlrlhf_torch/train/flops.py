"""FLOPs model for MFU accounting (copy of the DPO, SFT, RM and PPO parts
of vlrlhf_tpu/train/flops.py, so the port's MFU counts what the JAX
package's counts).

Conventions: a "token" is one position of the concatenated [chosen;
rejected] batch (2 * pairs * seq per DPO step). Matmul FLOPs are 2N per token
forward; fwd+bwd is 4N for LoRA training (the frozen base needs no dL/dW),
6N for full fine-tuning; causal attention counts at 0.5 occupancy.
"""

from __future__ import annotations


def lm_matmul_params(lm) -> int:
    """Weight-matmul parameter count per token for one LM forward."""
    h, ff, L, v = lm.hidden_size, lm.intermediate_size, lm.num_layers, lm.vocab_size
    attn = 2 * h * lm.num_heads * lm.head_dim_ + 2 * h * lm.num_kv_heads * lm.head_dim_
    return L * (attn + 3 * h * ff) + h * v


def attention_flops_per_token(lm, seq: int, fwd_bwd: bool) -> float:
    """Score + value matmul FLOPs per token (causal => 0.5 occupancy)."""
    mult = 3 + 1 if fwd_bwd else 2
    per_fwd = 0.5 * 4 * seq * lm.num_heads * lm.head_dim_ * lm.num_layers
    return per_fwd * (mult / 2)


def vision_flops_per_image(vision) -> float:
    """One ViT forward (frozen tower: forward only)."""
    n = vision.num_layers * (
        4 * vision.hidden_size**2 + 2 * vision.hidden_size * vision.mlp_dim
    )
    return 2 * n * vision.seq_len


def _bwd_mult(train_mode: str) -> int:
    return 4 if train_mode == "adapter" else 6


def dpo_flops_per_token(
    cfg, seq: int, ref_forward: bool = True, train_mode: str = "adapter"
) -> float:
    """FLOPs per concatenated-batch token of one DPO step: policy fwd+bwd +
    optional adapter-off ref fwd (2N) + attention. The frozen vision tower
    is accounted separately (per image, not per token)."""
    n_lm = lm_matmul_params(cfg.lm)
    mat = _bwd_mult(train_mode) * n_lm + (2 * n_lm if ref_forward else 0)
    attn = attention_flops_per_token(cfg.lm, seq, fwd_bwd=True)
    if ref_forward:
        attn += attention_flops_per_token(cfg.lm, seq, fwd_bwd=False)
    return mat + attn


def sft_flops_per_token(cfg, seq: int, train_mode: str = "adapter") -> float:
    return _bwd_mult(train_mode) * lm_matmul_params(cfg.lm) + attention_flops_per_token(
        cfg.lm, seq, fwd_bwd=True)


def rm_flops_per_token(cfg, seq: int, train_mode: str = "adapter") -> float:
    # the shape of SFT: one fwd+bwd over the [chosen; rejected] batch
    return sft_flops_per_token(cfg, seq, train_mode)


def ppo_flops_per_token(cfg, seq: int, ppo_epochs: int = 4, separate_value: bool = False,
                        train_mode: str = "adapter") -> float:
    """FLOPs per rollout-batch token of one PPO outer step (the stats pass
    and ppo_epochs inner updates; the rollout is counted apart, by tokens
    generated). Stats: policy fwd (2N) + adapter-off reference fwd (2N)
    [+ the value-adapter trunk's fwd]. Each epoch: policy fwd+bwd (4N
    adapter / 6N full) [+ the value trunk's fwd+bwd]."""
    n_lm = lm_matmul_params(cfg.lm)
    trunks = 3 if separate_value else 2
    stats = trunks * 2 * n_lm + trunks * attention_flops_per_token(cfg.lm, seq, fwd_bwd=False)
    per_epoch_trunks = 2 if separate_value else 1
    epoch = per_epoch_trunks * (_bwd_mult(train_mode) * n_lm
                                + attention_flops_per_token(cfg.lm, seq, fwd_bwd=True))
    return stats + ppo_epochs * epoch
